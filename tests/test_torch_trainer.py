"""The port's trainer against the JAX package's orchestration, on the CPU.

No JAX training runs: the JAX side is its pure-Python rules, applied to the
same config (``optim.resolve_optimizer``, ``optim.Schedule``, the
accumulation and weight-decay scaling of ``trainer.py``, the results.csv
columns from ``loss_items_to_row``, ``DetMetrics`` and the graph's
``attention_taps``). The port's trainer runs for real on a synthetic set of
8 images at 64 px: the (lr, lr_bias, momentum) it passes at every step must
equal the JAX schedule's, and a run interrupted after 2 epochs and resumed
for the third must end exactly where 3 straight epochs end.
"""

from __future__ import annotations

import csv

import numpy as np
import pytest
import torch

from tests._torch_port import few_torch_threads  # noqa: F401  (the module fixture below)

IMGSZ = 64
pytestmark = pytest.mark.usefixtures("few_torch_threads")
MODELS = {"cbam": "configs/models/yolov8_cbam.yaml", "eca": "configs/models/yolov8_eca.yaml",
          "spade": "configs/models/yolov8_spade.yaml", "plain": "configs/models/yolov8.yaml"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset

    return str(write_synthetic_dataset(tmp_path_factory.mktemp("ds"), n=8, size=IMGSZ, max_boxes=4, seed=5, n_val=4))


def config(data, project, name, **kw):
    from mga_yolo_tpu_torch.config import load_config

    base = dict(data=data, imgsz=IMGSZ, batch=4, nbs=8, epochs=3, device="cpu", workers=2, max_boxes=4,
                project=str(project), name=name, plots=False, warmup_epochs=1.0)
    base.update(kw)
    return load_config("configs/hyperparams/cbam_defaults.yaml", **base)


def jax_rules(cfg, data):
    """What the JAX trainer derives from the same config (trainer.py: the
    optimizer, the schedule, accumulate and the scaled weight decay), with
    its own dataset and loader for the step count."""
    import math

    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.data.dataset import MGADataset
    from mga_yolo_tpu.data.loader import DataLoader
    from mga_yolo_tpu.train import optim as JO

    t = cfg.train
    jcfg = jload({"data": data, "imgsz": IMGSZ, "max_boxes": 4})
    ds = MGADataset(jcfg, "train", augment=True)
    steps = max(len(DataLoader(ds, batch_size=t.batch, seed=t.seed, workers=1)), 1)
    iterations = math.ceil(len(ds) / max(t.batch, t.nbs)) * t.epochs
    opt = JO.resolve_optimizer(t.optimizer, 1, iterations, t.lr0, t.momentum, t.warmup_bias_lr)
    warm_mom = opt.momentum if opt.name in ("adam", "adamw") else t.warmup_momentum
    sched = JO.Schedule(lr0=opt.lr0, lrf=t.lrf, momentum=opt.momentum, warmup_epochs=t.warmup_epochs,
                        warmup_momentum=warm_mom, warmup_bias_lr=opt.warmup_bias_lr, epochs=t.epochs,
                        steps_per_epoch=steps, cos_lr=t.cos_lr)
    acc = max(round(t.nbs / t.batch), 1)
    return {"opt": opt, "sched": sched, "accumulate": acc, "wd": t.weight_decay * t.batch * acc / t.nbs}


@pytest.mark.parametrize("optimizer,epochs,cos_lr,nbs", [
    ("auto", 3, False, 8),        # few iterations: AdamW at the auto lr
    ("auto", 20001, False, 64),   # > 10k iterations: SGD(0.01, 0.9)
    ("SGD", 3, True, 64),
    ("Adam", 5, False, 16),
    ("RMSProp", 3, False, 4),
])
def test_optimizer_schedule_accumulate_and_decay_equal_jax(data, tmp_path, optimizer, epochs, cos_lr, nbs):
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    cfg = config(data, tmp_path, "t", optimizer=optimizer, epochs=epochs, cos_lr=cos_lr, nbs=nbs)
    tr = MGATrainer(cfg)
    want = jax_rules(cfg, data)
    o, jo = tr.opt, want["opt"]
    assert (o.name, o.lr0, o.momentum, o.warmup_bias_lr, o.auto_selected) == \
        (jo.name, jo.lr0, jo.momentum, jo.warmup_bias_lr, jo.auto_selected)
    assert tr.accumulate == want["accumulate"] and tr.weight_decay == want["wd"]
    js = want["sched"]
    assert tr.schedule.warmup_steps == js.warmup_steps and tr.steps_per_epoch == js.steps_per_epoch
    total = epochs * js.steps_per_epoch
    for s in sorted({*range(0, min(total, 130)), js.warmup_steps - 1, js.warmup_steps, total - 1}):
        assert tr.schedule.at(s) == js.at(s), s
    assert set(tr.state.opt_state) == {"sgd": {"m"}, "adam": {"m", "v"}, "adamw": {"m", "v"},
                                       "rmsprop": {"m", "sq"}}[o.name]


@pytest.mark.parametrize("model", list(MODELS))
def test_gate_and_spade_columns_follow_the_attention_taps(data, tmp_path, model):
    """alpha_P3..P5 for the attention layers with a ``beta`` gate (MaskCBAM,
    MaskECA), spade/P*/... for MaskSPADE, none for plain YOLOv8; tags from
    the JAX graph's ``attention_taps``; alpha = softplus of the EMA's beta."""
    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    tr = MGATrainer(config(data, tmp_path, "t", model=MODELS[model]))
    tags = sorted(jparse(MODELS[model], scale="n").attention_taps.values())
    assert sorted(tr.spec.attention_taps.values()) == tags
    with torch.no_grad():
        for name in tr.spec.attention_taps:
            if f"{name}.beta" in tr.state.ema_params:
                tr.state.ema_params[f"{name}.beta"].fill_(0.3)
    alpha, spade = tr._collect_alpha_params(), tr._collect_spade_stats()
    if model in ("cbam", "eca"):
        assert alpha == {f"alpha_{t}": float(np.log1p(np.exp(np.float32(0.3)))) for t in tags} and not spade
    elif model == "spade":
        assert not alpha and set(spade) == {f"spade/{t}/{k}_{s}" for t in tags for k in ("gamma", "beta")
                                            for s in ("mean", "std")}
        assert all(np.isfinite(v) for v in spade.values())
    else:
        assert not tags and not alpha and not spade


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def final_state(tr) -> dict:
    st = tr.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in {**st.ema_params, **st.ema_bn_stats}.items()})
    out.update({f"opt.{s}.{k}": v for s, slot in st.opt_state.items() for k, v in slot.items()})
    out.update({f"acc.{k}": v for k, v in (st.accum_grads or {}).items()})
    out["mtl"] = st.mtl_log_vars
    return {k: v.detach().clone() for k, v in out.items()}


def test_straight_run_equals_interrupted_and_resumed_run(data, tmp_path):
    """3 epochs straight against 2 epochs, a stop (KeyboardInterrupt after the
    second epoch's checkpoints), and ``resume`` for the third: the same
    masters, BN statistics, EMA, optimizer slots, accumulation buffer,
    counters and results.csv rows (all but the wall time). The straight run
    also passes the JAX schedule's (lr, lr_bias, momentum) at every step and
    writes the JAX trainer's results.csv columns."""
    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu.utils.csvlog import HEADER_ORDER, loss_items_to_row
    from mga_yolo_tpu.utils.metrics import DetMetrics
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    a = MGATrainer(config(data, tmp_path, "a"))
    seen = []
    step = a._train_step

    def spy(state, batch, lr, lr_bias, mom):
        seen.append((a._host_step, (lr, lr_bias, mom)))
        return step(state, batch, lr, lr_bias, mom)

    a._train_step = spy
    a.train()
    js = jax_rules(a.cfg, data)["sched"]
    assert [s for s, _ in seen] == list(range(6))
    assert [v for _, v in seen] == [js.at(s) for s in range(6)]

    header = list(csv_rows(a.save_dir / "results.csv")[0])
    extras = {"lr", "time", *DetMetrics().results_dict(),
              *(f"alpha_{t}" for t in jparse(MODELS["cbam"], scale="n").attention_taps.values())}
    want = {"epoch", *loss_items_to_row("train", np.zeros(10)), *loss_items_to_row("val", np.zeros(10)),
            "mtl/sigma2_det", "mtl/sigma2_seg", "mtl/w_det", "mtl/w_seg"}
    assert header == HEADER_ORDER + sorted(extras) and set(HEADER_ORDER) == want

    b = MGATrainer(config(data, tmp_path, "b", profile=True))  # a profile changes no number

    def stop(epoch=0, **_):
        if epoch == 1:
            raise KeyboardInterrupt

    b.callbacks.add("on_model_save", stop)
    with pytest.raises(KeyboardInterrupt):
        b.train()
    assert len(csv_rows(b.save_dir / "results.csv")) == 2
    assert (b.save_dir / "profile" / "trace.json").stat().st_size > 0
    r = MGATrainer(config(data, tmp_path, "b", resume=True))
    assert r.save_dir == b.save_dir and r.start_epoch == 2 and r.state.step == 4 and r._host_step == 4
    r.train()

    got, want_state = final_state(r), final_state(a)
    assert set(got) == set(want_state)
    for k in want_state:
        torch.testing.assert_close(got[k], want_state[k], rtol=0, atol=0, msg=k)
    assert (r.state.step, r.state.opt_step, r.state.last_apply) == (a.state.step, a.state.opt_step,
                                                                    a.state.last_apply)
    rows_a, rows_r = csv_rows(a.save_dir / "results.csv"), csv_rows(r.save_dir / "results.csv")
    assert [x["epoch"] for x in rows_r] == ["1.0", "2.0", "3.0"]
    assert [{k: v for k, v in x.items() if k != "time"} for x in rows_r] == \
        [{k: v for k, v in x.items() if k != "time"} for x in rows_a]


def test_callbacks_never_stop_training_and_absent_loggers_say_so(tmp_path, capsys, monkeypatch):
    import sys

    from mga_yolo_tpu_torch.utils.callbacks import CallbackBus, CSVLoggerCallback, MLflowLogger, WandBLogger

    bus = CallbackBus()
    seen = []
    bus.add("on_fit_epoch_end", lambda **kw: 1 / 0)
    bus.add("on_fit_epoch_end", lambda epoch=0, row=None, **_: seen.append((epoch, row)))
    CSVLoggerCallback(tmp_path / "mirror.csv").register(bus)
    bus.fire("on_fit_epoch_end", epoch=3, row={"lr": 0.1, "epoch": 4.0})
    assert seen == [(3, {"lr": 0.1, "epoch": 4.0})]
    assert "division by zero" in capsys.readouterr().out
    assert (tmp_path / "mirror.csv").read_text().splitlines() == ["epoch,lr", "4.0,0.1"]
    with pytest.raises(ValueError, match="unknown event"):
        bus.add("on_nothing", print)
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "mlflow", None)
    for logger in (WandBLogger("p", "n"), MLflowLogger("p", "n")):
        assert logger.run is None
        logger.register(bus)  # registers nothing
    out = capsys.readouterr().out
    assert "W&B logging off" in out and "MLflow logging off" in out
    assert len(bus._hooks["on_fit_epoch_end"]) == 3 and not bus._hooks["on_train_start"]
