"""PyTorch port, YOLOv8n-MGA-SPADE (MaskSPADE) against the JAX package: the
model's serving and training checks (tests/_torch_variant_checks.py, whose
docstring states their tolerances), and MaskSPADE as a module, in both
norms and both modes, at rtol 1e-5 / atol 1e-5 (float32 convolutions and
variances in another order).
"""

import jax
import numpy as np
import pytest

from tests._torch_port import few_torch_threads, load_layer, nchw, nhwc  # noqa: F401  (a module fixture)
from tests._torch_variant_checks import VariantChecks

pytestmark = pytest.mark.usefixtures("few_torch_threads")


class TestSpade(VariantChecks):
    NAME, CFG = "spade", "configs/models/yolov8_spade.yaml"


# ---------------------------------------------------------------- MaskSPADE


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm_type", ["in", "bn"])
def test_mask_spade_module_matches_flax(norm_type, train):
    """Output (and, with the BN in train mode, its running statistics) of
    one MaskSPADE, from the same weights and inputs, with a mask at half the
    feature's resolution (the bilinear resize takes part)."""
    from mga_yolo_tpu.models.attention import MaskSPADE as JSpade
    from mga_yolo_tpu_torch.models.attention import MaskSPADE

    rng = np.random.default_rng(0)
    feat = rng.normal(0.3, 1.5, (2, 12, 10, 24)).astype(np.float32)
    mask = rng.normal(0, 2, (2, 6, 5, 1)).astype(np.float32)
    jm = JSpade(channels=24, hidden=16, norm_type=norm_type)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), feat, mask, train=False))
    v = {"params": jax.tree_util.tree_map(lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                          v["params"]), "batch_stats": v.get("batch_stats")}
    if norm_type == "bn":
        v["batch_stats"] = {"norm": {"mean": rng.normal(0, 0.2, 24).astype(np.float32),
                                     "var": rng.uniform(0.5, 2.0, 24).astype(np.float32)}}
    tm = load_layer(MaskSPADE(24, hidden=16, norm_type=norm_type), "MaskSPADE", v["params"],
                    v["batch_stats"]).train(train)
    jv = {k: x for k, x in v.items() if x is not None}
    if train and norm_type == "bn":
        want, upd = jm.apply(jv, feat, mask, train=True, mutable=["batch_stats"])
    else:
        want, upd = jm.apply(jv, feat, mask, train=train), None
    got = tm(nchw(feat), nchw(mask))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if upd is not None:
        s = upd["batch_stats"]["norm"]
        np.testing.assert_allclose(tm.norm.running_mean.numpy(), np.asarray(s["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.norm.running_var.numpy(), np.asarray(s["var"]), rtol=1e-5, atol=1e-6)
    # no mask: the normalised features alone (with the statistics the train
    # forward left)
    jv = {**jv, **(upd or {})}
    np.testing.assert_allclose(nhwc(tm.eval()(nchw(feat))), np.asarray(jm.apply(jv, feat, None, train=False)),
                               rtol=1e-5, atol=1e-5)
