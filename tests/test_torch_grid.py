"""The port's grid orchestrator (``mga_yolo_tpu_torch/scripts``) against the
JAX package's ``mga_yolo_tpu/scripts/performance_comparison.py`` and
``tools/scripts/base_comparison.py``.

* The three cases of tests/test_grid_orchestrator.py on the port's module:
  two slots with a chatty and a silent child (real subprocesses standing in
  for the trainer), one slot with a failing job, and ``prepare_config``'s
  merge, which must load (PyYAML) to the JAX package's dict.
* ``main`` on ``configs/exp_cfg.yaml`` (its ``hyp`` and ``project`` moved
  under the test's directory) with ``launch`` stubbed builds the JAX grid's
  jobs and job configs; so does ``base_comparison``, which keeps the JAX
  tool's quirks (``prepare_config(hyp, "", ...)`` then the plain graph, exit
  0 when a job fails).
* ``launch`` runs the port's ``cli.train``.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import pytest
import yaml

from mga_yolo_tpu.scripts import performance_comparison as jpc
from mga_yolo_tpu_torch.scripts import performance_comparison as pc
from tests.test_grid_orchestrator import _stub_launch

ROOT = Path(__file__).resolve().parents[1]


def test_schedule_two_slots_chatty_and_silent(monkeypatch, tmp_path):
    """A silent job must not stall monitoring of a chatty one (and vice
    versa); both complete, progress is parsed from the chatty job."""
    chatty = (
        "import time\n"
        "for e in range(1, 4):\n"
        "    print(f'[MGA] epoch {e}/3 det=1.0', flush=True)\n"
        "    time.sleep(0.05)\n"
        "for i in range(2000):\n"  # a burst that could fill a pipe if unread
        "    print('x' * 100)\n"
    )
    silent = "import time; time.sleep(1.0)"
    jobs = [pc.Job("cbam", "n", 0, tmp_path / "a.yaml", "chatty"), pc.Job("eca", "n", 0, tmp_path / "b.yaml", "silent")]
    monkeypatch.setattr(pc, "launch", _stub_launch({"chatty": chatty, "silent": silent}))
    pc.schedule_loop(jobs, slots=2, poll=0.05)
    assert all(j.status == "done" for j in jobs), [j.status for j in jobs]
    assert jobs[0].progress == "3/3"


def test_schedule_serializes_on_one_slot_and_reports_failure(monkeypatch, tmp_path):
    ok = "print('[MGA] epoch 1/1 det=0.5', flush=True)"
    bad = "import sys; print('boom'); sys.exit(3)"
    jobs = [pc.Job("cbam", "n", 0, tmp_path / "a.yaml", "ok"), pc.Job("cbam", "n", 1, tmp_path / "b.yaml", "bad")]
    monkeypatch.setattr(pc, "launch", _stub_launch({"ok": ok, "bad": bad}))
    pc.schedule_loop(jobs, slots=1, poll=0.05)
    assert jobs[0].status == "done" and jobs[0].progress == "1/1"
    assert jobs[1].status == "failed(3)"


def test_prepare_config_merges_dynamic_keys(tmp_path):
    hyp = yaml.safe_load((ROOT / "configs/hyperparams/cbam_defaults.yaml").read_text())
    hyp.update(epochs=7, imgsz=64, save_layers=[23, 25, 27], note="a: b", empty=None)
    args = ("spade", "s", "data.yaml", "proj", "spade_s_fold0")
    out = pc.prepare_config(hyp, *args, tmp_path / "port")
    want = jpc.prepare_config(hyp, *args, tmp_path / "jax")
    cfg = yaml.safe_load(out.read_text())
    assert cfg == yaml.safe_load(want.read_text())
    assert cfg["model"].endswith("yolov8_spade.yaml")
    assert cfg["model_scale"] == "s"
    assert cfg["data"] == "data.yaml"
    assert cfg["epochs"] == 7 and cfg["name"] == "spade_s_fold0"


class _Done:
    """A finished child that printed one epoch line: what ``launch`` returns."""

    returncode = 0

    def __init__(self, code: int = 0):
        self.stdout = io.StringIO("[MGA] epoch 1/1 det=0.5\n")
        self.returncode = code

    def poll(self):
        return self.returncode


def _exp(tmp_path, **kw):
    exp = yaml.safe_load((ROOT / "configs/exp_cfg.yaml").read_text())
    exp.update({"hyp": str(ROOT / exp["hyp"]), "project": str(tmp_path / "grid"), **kw})
    path = tmp_path / "exp.yaml"
    path.write_text(yaml.safe_dump(exp))
    return path, exp


def _run(module, mod_pc, argv, monkeypatch, code=0):
    """``module.main(argv)`` with ``launch`` stubbed; the jobs and each
    job's config as PyYAML loads it (read before the other package's run
    writes the same paths)."""
    seen = []

    def launch(job):
        seen.append(job)
        return _Done(code)

    monkeypatch.setattr(mod_pc, "launch", launch)
    monkeypatch.setattr(mod_pc.time, "sleep", lambda s: None)
    module.main(argv)
    return [((j.variant, j.scale, j.fold, j.name, str(j.cfg_path), j.status, j.progress),
             yaml.safe_load(j.cfg_path.read_text())) for j in seen]


def test_main_builds_the_jax_grid_from_exp_cfg(tmp_path, monkeypatch):
    path, exp = _exp(tmp_path)
    want = _run(jpc, jpc, ["--exp", str(path)], monkeypatch)
    got = _run(pc, pc, ["--exp", str(path)], monkeypatch)
    assert got == want
    assert len(got) == len(exp["models"]) * len(exp["scales"]) * len(exp["folds"]) == 18
    (variant, scale, fold, name, _, status, progress), cfg = got[0]
    assert (variant, scale, fold, name, status, progress) == ("cbam", "n", 0, "cbam_n_fold0", "done", "1/1")
    assert cfg["data"] == f"{exp['folds_root']}/fold_0/data.yaml" and cfg["model"] == "configs/models/yolov8_cbam.yaml"


def test_main_exits_1_when_a_job_fails(tmp_path, monkeypatch):
    path, _ = _exp(tmp_path, models=["eca"], scales=["n"], folds=[0])
    for mod in (jpc, pc):
        with pytest.raises(SystemExit) as e:
            _run(mod, mod, ["--exp", str(path)], monkeypatch, code=2)
        assert e.value.code == 1


def test_base_comparison_builds_the_jax_grid(tmp_path, monkeypatch):
    from mga_yolo_tpu_torch.scripts import base_comparison
    from tools.scripts import base_comparison as jbase

    path, exp = _exp(tmp_path, hyp=str(ROOT / "configs/hyperparams/base_defaults.yaml"), folds=[0, 1])
    want = _run(jbase, jpc, ["--exp", str(path)], monkeypatch, code=4)
    got = _run(base_comparison, pc, ["--exp", str(path)], monkeypatch, code=4)  # exits 0 with failed jobs
    assert got == want and len(got) == 4
    for key, cfg in got:
        assert key[0] == "base" and key[5] == "failed(4)"
        assert cfg["model"] == "configs/models/yolov8.yaml" and cfg["enabled"] is False


def test_launch_runs_the_ports_train_cli(monkeypatch, tmp_path):
    cmds = []

    class Popen:
        def __init__(self, cmd, **kw):
            cmds.append((cmd, kw))

    monkeypatch.setattr(pc.subprocess, "Popen", Popen)
    pc.launch(pc.Job("cbam", "n", 0, tmp_path / "j.yaml", "j"))
    (cmd, kw), = cmds
    assert cmd == [sys.executable, "-m", "mga_yolo_tpu_torch.cli.train", "--cfg", str(tmp_path / "j.yaml")]
    assert kw["stdout"] == pc.subprocess.PIPE and kw["text"]
