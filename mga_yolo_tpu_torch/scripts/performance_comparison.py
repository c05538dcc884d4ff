"""Experiment grid orchestrator: (attention variant x scale x fold) sweeps.

Counterpart of ``mga_yolo_tpu/scripts/performance_comparison.py`` (the
reference's ``mga_yolo/scripts/performance_comparison.py:85-265``): builds
jobs from an experiment YAML, merges the hyperparameter YAML with dynamic
model/data/name keys, launches each job as a subprocess
(``python -m mga_yolo_tpu_torch.cli.train --cfg <job yaml>``), schedules up
to ``slots`` concurrent jobs, and regex-parses epoch progress from child
stdout. YAML is read and written with the port's own subset
(``utils/yaml_lite.py``). The device is the merged config's own
``device`` key: unset, every job trains on the card (``slots`` jobs share
it); ``device: cpu`` in the hyperparameter YAML runs them on the CPU.

Experiment YAML schema (reference exp_cfg.yaml):
    models: [cbam, eca, spade]        # attention variants
    scales: [n, s]
    folds: [0, 1, 2]                  # fold data YAMLs at {folds_root}/fold_{k}/data.yaml
    folds_root: /path/to/folds        # or data: one data YAML for every job
    hyp: configs/hyperparams/cbam_defaults.yaml
    project: runs/grid
    slots: 1

    python -m mga_yolo_tpu_torch.scripts.performance_comparison --exp exp.yaml
"""

from __future__ import annotations

import argparse
import itertools
import queue
import re
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from mga_yolo_tpu_torch.utils import yaml_lite

EPOCH_RE = re.compile(r"epoch (\d+)/(\d+)")


@dataclass
class Job:
    variant: str
    scale: str
    fold: int
    cfg_path: Path
    name: str
    proc: Optional[subprocess.Popen] = None
    status: str = "pending"
    progress: str = ""
    # one daemon reader thread per job drains child stdout into this queue so
    # the scheduler never blocks on a silent job and a chatty job can never
    # fill its pipe while the monitor is looking elsewhere
    lines: "queue.Queue[str]" = field(default_factory=queue.Queue)
    _reader: Optional[threading.Thread] = None

    def start_reader(self) -> None:
        assert self.proc is not None and self.proc.stdout is not None

        def pump(stream, q):
            for line in iter(stream.readline, ""):
                q.put(line)
            stream.close()

        self._reader = threading.Thread(target=pump, args=(self.proc.stdout, self.lines), daemon=True)
        self._reader.start()

    def drain(self) -> list[str]:
        out = []
        while True:
            try:
                out.append(self.lines.get_nowait())
            except queue.Empty:
                return out


def prepare_config(
    hyp: dict, variant: str, scale: str, data_yaml: str, project: str, name: str, out_dir: Path
) -> Path:
    """Merge hyp YAML with dynamic model/scale/data/name (reference :124-147)."""
    cfg = dict(hyp)
    cfg["model"] = f"configs/models/yolov8_{variant}.yaml"
    cfg["model_scale"] = scale
    cfg["data"] = data_yaml
    cfg["project"] = project
    cfg["name"] = name
    out = out_dir / f"{name}.yaml"
    out.parent.mkdir(parents=True, exist_ok=True)
    yaml_lite.dump(cfg, out)
    return out


def launch(job: Job) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "mga_yolo_tpu_torch.cli.train", "--cfg", str(job.cfg_path)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def schedule_loop(jobs: list[Job], slots: int = 1, poll: float = 0.2) -> None:
    """Run jobs with at most ``slots`` concurrent subprocesses (reference :231-256).

    Non-blocking monitoring: every child's stdout is pumped by its own daemon
    thread (Job.start_reader), so this loop only ever reads from in-memory
    queues and a stalled/silent job cannot block progress parsing of others.
    """
    pending = list(jobs)
    running: list[Job] = []
    while pending or running:
        while pending and len(running) < slots:
            job = pending.pop(0)
            job.proc = launch(job)
            job.start_reader()
            job.status = "running"
            running.append(job)
            print(f"[grid] started {job.name}")
        for job in list(running):
            assert job.proc is not None
            for line in job.drain():
                m = EPOCH_RE.search(line)
                if m:
                    job.progress = f"{m.group(1)}/{m.group(2)}"
                    print(f"[grid] {job.name}: epoch {job.progress}")
            if job.proc.poll() is not None:
                for line in job.drain():  # flush tail output after exit
                    m = EPOCH_RE.search(line)
                    if m:
                        job.progress = f"{m.group(1)}/{m.group(2)}"
                job.status = "done" if job.proc.returncode == 0 else f"failed({job.proc.returncode})"
                print(f"[grid] {job.name}: {job.status}")
                running.remove(job)
        time.sleep(poll)


def main(argv=None) -> list[Job]:
    """Run the grid; exits 1 when a job fails, else returns the jobs."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("mga-grid")
    p.add_argument("--exp", required=True, help="experiment YAML (see module docstring)")
    args = p.parse_args(argv)

    exp = yaml_lite.load(args.exp)
    hyp = yaml_lite.load(exp["hyp"]) or {}

    project = exp.get("project", "runs/grid")
    folds_root = exp.get("folds_root")
    cfg_dir = Path(project) / "_configs"
    jobs = []
    for variant, scale, fold in itertools.product(
        exp.get("models", ["cbam"]), exp.get("scales", ["n"]), exp.get("folds", [0])
    ):
        name = f"{variant}_{scale}_fold{fold}"
        data_yaml = str(Path(folds_root) / f"fold_{fold}" / "data.yaml") if folds_root else exp["data"]
        cfg_path = prepare_config(hyp, variant, scale, data_yaml, project, name, cfg_dir)
        jobs.append(Job(variant, scale, fold, cfg_path, name))

    schedule_loop(jobs, slots=int(exp.get("slots", 1)))
    failed = [j for j in jobs if j.status != "done"]
    print(f"[grid] finished: {len(jobs) - len(failed)}/{len(jobs)} ok")
    if failed:
        sys.exit(1)
    return jobs


if __name__ == "__main__":
    main()
