"""PyTorch port, the CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so the ``cuda``-marked
tests also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card they skip (the kernels have no CPU or interpret mode); the
wrapper's input checks, which are plain Python, run everywhere.

Tolerances on the card: the CAM gate to atol 1e-5 in float32 and bfloat16
(both sum in float32, in another order; the gate is a sigmoid in (0, 1)),
its autograd gradients rtol 1e-4 / atol 1e-5 (the backward recomputes the
plain version); NMS exactly (the kernel rounds its IoU as the plain version
does); the DFL backward rtol/atol 2e-6 in float32 (dz rounded op for op;
the softmax sum and expf differ in the last ulp) and rtol 8e-3 / atol 2e-4
in bfloat16 (one bf16 ulp across a rounding boundary), the tolerances of
tests/test_dfl_bwd_pallas.py; the masked pool's max descriptors exactly
where a pixel has m > 0.5 (a max is the same in any order), the rest rtol
1e-5 / atol 1e-6 in float32 (float32 sums in another order) and one bf16 ulp
in bfloat16 (the same sums rounded once to bf16), its x and m gradients
rtol 1e-4 / atol 1e-5 of autograd through the plain version; the masked
reductions (csrc/masked_reductions.cu) in float32 whatever the input type:
msum, wsum and gsum / N rtol 1e-5 / atol 1e-6 (float32 sums in another
order), mmax and cnt exactly.
"""

import numpy as np
import pytest
import torch

from mga_yolo_tpu_torch.ops import cam_gate as tcg
from mga_yolo_tpu_torch.ops import dfl_bwd as tdfl
from mga_yolo_tpu_torch.ops import masked_pool as tmp
from mga_yolo_tpu_torch.ops import masked_reductions as tmr
from mga_yolo_tpu_torch.ops import nms as tnms


def _cam_case(kind="random", b=2, h=8, w=8, c=32, seed=0):
    """NCHW features, (B, 1, H, W) mask probabilities, nn.Linear MLP weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, c, h, w))
    if kind == "tiny":
        m = np.zeros((b, 1, h, w))
    elif kind == "no_pixel":
        m = rng.uniform(0.05, 0.45, (b, 1, h, w))
    else:
        m = rng.uniform(0, 1, (b, 1, h, w)) ** 2
    hid = max(1, c // 16)
    ws = [rng.normal(0, 0.2, s) for s in ((hid, c), (hid,), (c, hid), (c,))]
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, m, *ws)]


CAM_CASES = {
    "random": dict(),
    "tiny": dict(kind="tiny"),
    "no_pixel": dict(kind="no_pixel"),
    "ragged_16x7": dict(h=7, w=16, seed=4),
    "p3_width": dict(h=80, w=80, c=64, b=2, seed=5),
    "p5_width": dict(h=20, w=20, c=256, b=2, seed=6),
    "odd_channels": dict(h=9, w=11, c=40, seed=7),
    "p4_width": dict(h=40, w=40, c=128, b=2, seed=11),
    "odd_plane_41x43": dict(h=41, w=43, c=24, seed=12),  # N odd: one element a lane, no 16-byte loads
}


def _pred(b=2, a=300, nc=3, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(40, 200, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    probs = rng.uniform(0, 1, (b, a, nc)) ** 3
    if ties:
        probs = np.round(probs * 8) / 8
    return torch.from_numpy(np.concatenate([xy, wh, probs], -1).astype(np.float32))


NMS_CASES = {
    "multi_class": dict(pred=dict(nc=3), kw=dict(conf_thres=0.1)),
    "k_84": dict(pred=dict(a=84, nc=2, seed=2), kw=dict(conf_thres=0.01)),
    "full_1024": dict(pred=dict(a=1500, nc=1, seed=3), kw=dict(conf_thres=0.001)),
    "all_below_conf": dict(pred=dict(seed=4), kw=dict(conf_thres=1.5)),
    "score_ties": dict(pred=dict(nc=2, seed=5, ties=True), kw=dict(conf_thres=0.1)),
    "multi_label": dict(pred=dict(nc=3, seed=6), kw=dict(conf_thres=0.1, multi_label=True)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CAM_CASES))
def test_cam_gate_kernel_matches_plain(card, case, dtype):
    args = [a.to(card, dtype) for a in _cam_case(**CAM_CASES[case])]
    before = tcg.launches
    got = tcg.cam_gate(*args)
    want = tcg.cam_gate_ref(*args)
    torch.cuda.synchronize()
    assert tcg.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_kernel_matches_plain(card, case):
    pred = _pred(**NMS_CASES[case]["pred"])
    before = tnms.launches
    got = tnms.nms(pred.to(card), **NMS_CASES[case]["kw"])
    want = tnms.nms(pred, **NMS_CASES[case]["kw"])
    torch.cuda.synchronize()
    assert tnms.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7)], ids=["plane_64", "plane_35"])
def test_cam_gate_kernel_on_channel_slice(card, dtype, hw):
    """Channels 1..32 of 33: the batch stride is 33*N, not 32*N. With N = 64
    every plane starts on 16 bytes (vector loads); with N = 35 none does."""
    x, m, w1, b1, w2, b2 = _cam_case(b=3, h=hw[0], w=hw[1], c=33, seed=13)
    x = x.to(card, dtype)[:, 1:]
    m, b1 = m.to(card, dtype), b1.to(card, dtype)
    w1, w2, b2 = (a.to(card, dtype).contiguous() for a in (w1[:, 1:], w2[1:], b2[1:]))
    got = tcg.cam_gate(x, m, w1, b1, w2, b2)
    torch.testing.assert_close(got, tcg.cam_gate_ref(x, m, w1, b1, w2, b2), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cam_gate_kernel_repeated_calls_and_graph_replays(card):
    """Ten calls in a row, then a captured CUDA graph replayed on new inputs
    copied in place: each result equals the plain version (nothing of one
    call is left for the next)."""
    args = [a.to(card, torch.bfloat16) for a in _cam_case(h=40, w=40, c=128, b=8, seed=14)]
    want = tcg.cam_gate_ref(*args)
    for _ in range(10):
        torch.testing.assert_close(tcg.cam_gate(*args), want, rtol=0, atol=1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tcg.cam_gate(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tcg.cam_gate(*args)
    for seed in (15, 16, 17):
        fresh = [a.to(card, torch.bfloat16) for a in _cam_case(h=40, w=40, c=128, b=8, seed=seed)]
        for a, f in zip(args, fresh):
            a.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, tcg.cam_gate_ref(*args), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cam_gate_kernel_on_two_streams_at_once(card):
    cases = [[a.to(card, torch.bfloat16) for a in _cam_case(h=80, w=80, c=64, b=8, seed=s)] for s in (18, 19)]
    streams = [torch.cuda.Stream() for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(5):
        for s, args in zip(streams, cases):
            with torch.cuda.stream(s):
                outs.append(tcg.cam_gate(*args))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        torch.testing.assert_close(out, tcg.cam_gate_ref(*cases[i % 2]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b", [1, 8, 16, 48])
def test_counter_ring_never_hands_out_a_captured_range(b):
    """A range taken during capture is never handed out again: not by the
    next 2**20 / b + 1 takes (more than one wrap of the cursor), nor by a
    second capture; eager ranges are reused after a wrap."""
    ring = tcg.CounterRing(1 << 20)
    ring.cursor = ring.size - 3 * b  # just before the wrap
    lo = ring.take(b, captured=True)
    first = ring.take(b)
    offs = [first] + [ring.take(b) for _ in range(ring.size // b)]
    offs = np.array(offs)
    assert ((offs + b <= lo) | (offs >= lo + b)).all()
    assert ((offs >= 0) & (offs + b <= ring.size)).all()
    assert first in offs[1:]  # eager ranges come round again
    other = ring.take(b, captured=True)
    assert other + b <= lo or other >= lo + b
    assert ring.reserved == sorted([(lo, lo + b), (other, other + b)])


def test_counter_ring_takes_a_released_capture_range_again():
    """Once its graph is gone, a captured range goes back into turn; a
    release of a range that is not reserved is refused."""
    ring = tcg.CounterRing(64)
    held = [ring.take(16, captured=True) for _ in range(4)]
    ring.release(held[1])
    assert ring.reserved == [(0, 16), (32, 48), (48, 64)]
    assert ring.take(16) == 16  # the only free range
    with pytest.raises(ValueError, match="no captured counters at offset 16"):
        ring.release(16)
    for off in (held[0], held[2], held[3]):
        ring.release(off)
    assert ring.reserved == [] and [ring.take(16) for _ in range(4)] == [32, 48, 0, 16]


def test_counter_ring_refuses_when_captures_hold_it_all():
    ring = tcg.CounterRing(64)
    for _ in range(4):
        ring.take(16, captured=True)
    with pytest.raises(RuntimeError, match="whole counter ring"):
        ring.take(16)
    with pytest.raises(ValueError):
        tcg.CounterRing(8).take(9)


@pytest.mark.cuda
def test_cam_gate_graph_replays_beside_eager_calls_after_a_wrap(card):
    """The captured graph's counters under a wrap: the cursor is moved to
    just before the wrap, a graph of k calls is captured, one wrap's worth
    of eager calls follows (so the cursor reaches the captured range again),
    then the graph replays on one stream while k eager calls run on another,
    three times: both streams first spin ~10 ms on the card, so every launch
    is queued before either starts and the two run side by side. Every gate
    equals the plain version. A smoke check of the ring on the card: the
    ring of the parent, which handed the captured range out again, passed
    it too; the guard against that is the CPU test
    test_counter_ring_never_hands_out_a_captured_range."""
    b, k = 64, 32
    args = [a.to(card) for a in _cam_case(b=b, h=8, w=8, c=64, seed=20)]
    other = [a.to(card) for a in _cam_case(b=b, h=8, w=8, c=64, seed=21)]
    want, want_other = tcg.cam_gate_ref(*args), tcg.cam_gate_ref(*other)
    tcg.cam_gate(*args)  # the ring exists before capture
    counters, ring = tcg._rings[args[0].device.index]
    ring.cursor = ring.size - k * b
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        outs = [tcg.cam_gate(*args) for _ in range(k)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    eager = []
    for _ in range(3):
        # a ring that hands out counters in turn gives the next k eager calls
        # the captured range
        torch.cuda.synchronize()
        for _ in range(ring.size // b - k):
            tcg.cam_gate(*other)
        for s in (s1, s2):
            s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s1):
            torch.cuda._sleep(20_000_000)
            graph.replay()
        with torch.cuda.stream(s2):
            torch.cuda._sleep(20_000_000)
            eager += [tcg.cam_gate(*other) for _ in range(k)]
        torch.cuda.synchronize()
        for out in outs:
            torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    for out in eager:
        torch.testing.assert_close(out, want_other, rtol=0, atol=1e-5)
    assert int(counters.abs().sum()) == 0  # every launch left its counters at zero


@pytest.mark.cuda
def test_cam_gate_counters_of_a_destroyed_graph_return_to_the_ring(card):
    """A graph's captured calls reserve their counters while it lives; once
    the graph is destroyed, the library queues their release, and the next
    call gives them back to the ring."""
    import gc
    import time

    args = [a.to(card) for a in _cam_case(b=4, h=8, w=8, c=64, seed=22)]
    want = tcg.cam_gate_ref(*args)
    tcg.cam_gate(*args)  # the ring exists before capture
    ring = tcg._rings[args[0].device.index][1]
    before = list(ring.reserved)
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        out = tcg.cam_gate(*args)
    mine = sorted(set(ring.reserved) - set(before))
    assert len(mine) == 1 and mine[0][1] - mine[0][0] == 4
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    del graph, out
    gc.collect()
    torch.cuda.synchronize()
    deadline = time.monotonic() + 5.0
    while mine[0] in ring.reserved and time.monotonic() < deadline:
        time.sleep(0.01)
        tcg.cam_gate(*args)  # each call collects the released ranges
    assert mine[0] not in ring.reserved
    assert ring.reserved == before


def test_cam_gate_checks_refuse_what_the_kernel_cannot_take():
    x, m, w1, b1, w2, b2 = _cam_case()
    tcg._check(x, m, w1, b1, w2, b2)  # NCHW-contiguous: taken
    tcg._check(x[:, :16], m, w1[:, :16].contiguous(), b1, w2[:16].contiguous(), b2[:16])  # channel slice
    with pytest.raises(ValueError, match="contiguous H\\*W planes"):
        tcg._check(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), m, w1, b1, w2, b2)  # NHWC memory
    with pytest.raises(ValueError, match="m must be"):
        tcg._check(x, m[:, :, :4], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w1 is"):
        tcg._check(x, m, w1.double(), b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcg._check(*(a.half() for a in (x, m, w1, b1, w2, b2)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "tiny", "p3_width", "p5_width"])
def test_cam_gate_gradient_matches_plain_autograd(card, case):
    """The autograd Function (kernel forward, recomputed plain backward)
    against autograd through the plain version, all six input gradients."""
    args = [a.to(card) for a in _cam_case(**CAM_CASES[case])]
    g = torch.randn(args[0].shape[:2], device=card)
    grads = []
    for fn in (tcg.cam_gate, tcg.cam_gate_ref):
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = tcg.launches
        out = fn(*leaves)
        assert tcg.launches == before + (fn is tcg.cam_gate)
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _dfl_case(b=2, a=84, r=16, dtype=torch.float32, seed=0, planar=False, device="cpu"):
    """pd (B, A, 4, R) with +-40 logits and integer targets; aux (B, A, 4)
    or permuted views of planar (4, B, A) tensors."""
    rng = np.random.default_rng(seed)
    pd = rng.normal(0, 3, (b, a, 4, r)).astype(np.float32)
    pd[0, 0], pd[0, 1] = 40.0, -40.0
    aux = [rng.normal(r / 2, 3, (b, a, 4)), rng.normal(0, 1, (b, a, 4)), rng.uniform(0, r - 1, (b, a, 4))]
    aux[2][0, :4] = np.floor(aux[2][0, :4])
    ltrb, g_ltrb, target = (torch.from_numpy(x.astype(np.float32)).to(device) for x in aux)
    if planar:
        ltrb, g_ltrb, target = (t.permute(2, 0, 1).contiguous().permute(1, 2, 0) for t in (ltrb, g_ltrb, target))
    g_ce = torch.from_numpy(rng.uniform(0, 2, (b, a)).astype(np.float32)).to(device)
    return torch.from_numpy(pd).to(device, dtype), ltrb, g_ltrb, g_ce, target


DFL_CASES = {
    "B2A84": dict(),
    "ragged_A1050": dict(b=1, a=1050, seed=1),
    "path_level": dict(b=3, a=400, seed=2),
    "R8": dict(r=8, seed=3), "R32": dict(r=32, seed=4), "R64": dict(r=64, seed=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True], ids=["BA4", "planar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(DFL_CASES))
def test_dfl_bwd_kernel_matches_plain(card, case, dtype, planar):
    args = _dfl_case(dtype=dtype, planar=planar, device=card, **DFL_CASES[case])
    before = tdfl.launches
    got = tdfl.dfl_decode_ce_bwd(*args)
    want = tdfl.dfl_decode_ce_bwd_ref(*args)
    torch.cuda.synchronize()
    assert tdfl.launches == before + 1 and got.dtype == dtype and got.shape == args[0].shape
    # the kernel rounds dz op for op as the plain version; softmax sums and
    # expf differ in the last ulp. bf16: one bf16 ulp across a boundary.
    rtol, atol = (2e-6, 2e-6) if dtype == torch.float32 else (8e-3, 2e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_dfl_bwd_checks_refuse_what_the_kernel_cannot_take():
    pd, ltrb, g_ltrb, g_ce, target = _dfl_case()
    tdfl._check(pd, ltrb, g_ltrb, g_ce, target)
    tdfl._check(pd.bfloat16(), ltrb, g_ltrb, g_ce, target)
    tdfl._check(pd, *(t.permute(2, 0, 1).contiguous().permute(1, 2, 0) for t in (ltrb, g_ltrb)), g_ce, target)
    for r in (4, 12, 128):  # R without a template instance
        p = torch.zeros(2, 84, 4, r)
        with pytest.raises(ValueError, match="R in"):
            tdfl._check(p, ltrb, g_ltrb, g_ce, target)
    with pytest.raises(ValueError, match="must be \\(B, A, 4, R\\)"):
        tdfl._check(pd.reshape(2, 84, 64), ltrb, g_ltrb, g_ce, target)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tdfl._check(pd.half(), ltrb, g_ltrb, g_ce, target)
    with pytest.raises(ValueError, match="contiguous"):
        tdfl._check(pd.transpose(0, 1).contiguous().transpose(0, 1), ltrb, g_ltrb, g_ce, target)
    misaligned = torch.zeros(pd.numel() + 1)[1:].reshape(pd.shape)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
        tdfl._check(misaligned, ltrb, g_ltrb, g_ce, target)
    with pytest.raises(ValueError, match="g_ce must be"):
        tdfl._check(pd, ltrb, g_ltrb, g_ce[:, :10], target)
    with pytest.raises(TypeError, match="target must be float32"):
        tdfl._check(pd, ltrb, g_ltrb, g_ce, target.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        tdfl.dfl_decode_ce_bwd(pd.to("meta"), ltrb, g_ltrb, g_ce, target)


def _sorted_candidates(b, k, seed, n_classes=3):
    """Score-sorted, class-offset candidates (B, k, 4), (B, k), with ties."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 160, (b, k, 2))], -1)
    boxes += (rng.integers(0, n_classes, (b, k)) * 7680.0)[..., None]
    scores = np.round(rng.uniform(0, 1, (b, k)) * 64) / 64
    order = np.argsort(-scores, axis=1, kind="stable")
    return (torch.from_numpy(np.take_along_axis(boxes, order[..., None], 1).astype(np.float32)),
            torch.from_numpy(np.take_along_axis(scores, order, 1).astype(np.float32)))


def _chain(b, k):
    """Box i overlaps box i + 1 above 0.45 (IoU 7/13) and box i + 2 below
    (IoU 4/16): keep alternates, each decision resting on the one before."""
    x = 3.0 * np.arange(k)
    boxes = np.stack([x, np.zeros(k), x + 10, np.full(k, 10.0)], -1)
    scores = 1.0 - np.arange(k) / (2 * k)
    return (torch.from_numpy(np.tile(boxes, (b, 1, 1)).astype(np.float32)),
            torch.from_numpy(np.tile(scores, (b, 1)).astype(np.float32)))


SUPPRESS_CASES = {
    **{f"k{k}": dict(k=k, conf=0.01) for k in (1, 63, 64, 65, 2048)},
    "k1024_path": dict(k=1024, conf=0.001),
    "conf_cut_in_word": dict(k=300, cut=100),  # the first 100 live: word 1 is cut at bit 36
    "chain_130": dict(k=130, chain=True),
    "chain_2048": dict(k=2048, chain=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SUPPRESS_CASES))
def test_suppress_kernel_matches_plain(card, case):
    spec = SUPPRESS_CASES[case]
    k = spec["k"]
    if spec.get("chain"):
        boxes, scores = _chain(3, k)
        conf = 0.0
    else:
        boxes, scores = _sorted_candidates(3, k, seed=k)
        conf = spec.get("conf", 0.5)
        if "cut" in spec:  # scores 1 .. 0 evenly, conf between candidates cut - 1 and cut
            scores = torch.linspace(1, 0, k).expand(3, k).contiguous()
            conf = 1 - (spec["cut"] - 0.5) / (k - 1)
    before = tnms.launches
    got = tnms.suppress(boxes.to(card), scores.to(card), 0.45, conf)
    torch.cuda.synchronize()
    assert tnms.launches == before + 1
    want = tnms.suppress_ref(boxes, scores, 0.45, conf)
    assert torch.equal(got.cpu(), want), f"{int((got.cpu() != want).sum())} candidates differ"
    if spec.get("chain"):
        assert torch.equal(want[0], torch.arange(k) % 2 == 0)
    if "cut" in spec:
        assert not bool(want[:, spec["cut"]:].any()) and bool(want[:, :spec["cut"]].any())


@pytest.mark.cuda
def test_suppress_kernel_refuses_k_above_its_limit(card):
    boxes, scores = _chain(1, 2049)
    with pytest.raises(ValueError, match="exceeds the kernel"):
        tnms.suppress(boxes.to(card), scores.to(card), 0.45, 0.0)


def test_suppress_checks_refuse_what_the_kernel_cannot_take():
    boxes, scores = torch.zeros((2, 8, 4)), torch.zeros((2, 8))
    for bad, err in (((boxes[:, :4], scores), ValueError), ((boxes.double(), scores), TypeError),
                     ((boxes.transpose(0, 1).contiguous().transpose(0, 1), scores), ValueError),
                     ((boxes[:, :0], scores[:, :0]), ValueError)):
        with pytest.raises(err):
            tnms._check(*bad)
    tnms._check(boxes, scores)


def _pool_case(kind="random", b=2, h=8, w=8, c=32, seed=0):
    x, m, *_ = _cam_case(kind, b, h, w, c, seed)
    return x, m


POOL_CASES = {
    **{k: CAM_CASES[k] for k in ("random", "tiny", "no_pixel", "ragged_16x7", "p3_width", "p5_width")},
    "channel_tile_72": dict(h=10, w=12, c=72, seed=8),
    "p4_width_b8": dict(h=40, w=40, c=128, b=8, seed=9),
    "p3_width_b1": dict(h=80, w=80, c=64, b=1, seed=40),  # 64 blocks: fewer than the card's SMs
    "p3_width_b16": dict(h=80, w=80, c=64, b=16, seed=41),  # the train path's shapes
    "p4_width_b16": dict(h=40, w=40, c=128, b=16, seed=42),
    "p5_width_b16": dict(h=20, w=20, c=256, b=16, seed=43),  # 16 channels a block, 2 a warp
    "odd_plane_41x43": dict(h=41, w=43, c=24, seed=12),  # N odd: one element a load, no 16-byte loads
    "one_channel": dict(h=9, w=16, c=1, seed=44),
    "c37_b16": dict(h=9, w=11, c=37, b=16, seed=45),  # C a multiple of no tile > 1: a ragged last tile
    "plane_5x5": dict(h=5, w=5, c=16, seed=46),  # N < 32, odd
    "plane_4x4": dict(h=4, w=4, c=16, seed=47),  # N < 32, 16-byte loads
    "tile_64": dict(h=4, w=5, c=1024, b=16, seed=48),  # the widest tile: 8 channels a warp
}


def _assert_pool_close(got, want, m):
    """Max descriptors exact where a pixel has m > 0.5; the rest within the
    float32 tolerance, or one bf16 ulp."""
    (avg, mx), (avg_w, mx_w) = got, want
    assert avg.dtype == mx.dtype == avg_w.dtype and avg.shape == avg_w.shape
    if avg.dtype == torch.float32:
        torch.testing.assert_close(avg, avg_w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(mx, mx_w, rtol=1e-5, atol=1e-6)
    else:  # one bf16 ulp: 2^-7 relative
        for g, w in ((avg, avg_w), (mx, mx_w)):
            torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -7, atol=1e-6)
    any_sel = (m.float() > 0.5).flatten(1).any(1)
    torch.testing.assert_close(mx[any_sel], mx_w[any_sel], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_masked_pool_kernel_matches_plain(card, case, dtype):
    x, m = (a.to(card, dtype) for a in _pool_case(**POOL_CASES[case]))
    before = tmp.launches
    got = tmp.masked_pool(x, m)
    want = tmp.masked_pool_ref(x, m)
    torch.cuda.synchronize()
    assert tmp.launches == before + 1
    _assert_pool_close(got, want, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("view", ["slice_plane_64", "slice_plane_35", "offset_one"])
def test_masked_pool_kernel_on_unaligned_views(card, dtype, view):
    """Channels 3..34 of 35 (x[:, 3:]): with N = 64 every plane starts on 16
    bytes (16-byte loads), with N = 35 none does; and a contiguous tensor
    one element past a 16-byte boundary (one element a load)."""
    hw = (5, 7) if view == "slice_plane_35" else (8, 8)
    x, m = (a.to(card, dtype) for a in _pool_case(b=3, h=hw[0], w=hw[1], c=35, seed=49))
    if view == "offset_one":
        buf = torch.empty(x.numel() + 1, device=card, dtype=dtype)
        x = buf[1:].view(x.shape).copy_(x)
    else:
        x = x[:, 3:]
    got = tmp.masked_pool(x, m)
    _assert_pool_close(got, tmp.masked_pool_ref(x, m), m)


@pytest.mark.cuda
def test_masked_pool_kernel_repeated_calls_and_graph_replays(card):
    """Ten calls in a row, then a captured CUDA graph replayed on new inputs
    copied in place: each result equals the plain version (nothing of one
    call is left for the next)."""
    x, m = (a.to(card, torch.bfloat16) for a in _pool_case(h=40, w=40, c=128, b=8, seed=50))
    want = tmp.masked_pool_ref(x, m)
    for _ in range(10):
        _assert_pool_close(tmp.masked_pool(x, m), want, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmp.masked_pool(x, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmp.masked_pool(x, m)
    for seed in (51, 52, 53):
        fresh = [a.to(card, torch.bfloat16) for a in _pool_case(h=40, w=40, c=128, b=8, seed=seed)]
        x.copy_(fresh[0])
        m.copy_(fresh[1])
        graph.replay()
        torch.cuda.synchronize()
        _assert_pool_close(out, tmp.masked_pool_ref(x, m), m)


@pytest.mark.cuda
@pytest.mark.parametrize("cotangent", ["avg", "both"])
@pytest.mark.parametrize("case", ["random", "tiny", "no_pixel", "p3_width", "p5_width"])
def test_masked_pool_gradient_matches_plain_autograd(card, case, cotangent):
    """The autograd Function (kernel forward, analytic plain backward)
    against autograd through the plain version, x and m gradients, with a
    cotangent on the average only (as MaskECA gives) and on both outputs."""
    x, m = (a.to(card) for a in _pool_case(**POOL_CASES[case]))
    ga, gm = torch.randn((2,) + x.shape[:2], device=card)
    grads = []
    for fn in (tmp.masked_pool, tmp.masked_pool_ref):
        leaves = [x.clone().requires_grad_(True), m.clone().requires_grad_(True)]
        before = tmp.launches
        avg, mx = fn(*leaves)
        assert tmp.launches == before + (fn is tmp.masked_pool)
        loss = (avg * ga).sum() + ((mx * gm).sum() if cotangent == "both" else 0)
        grads.append(torch.autograd.grad(loss, leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_masked_pool_checks_refuse_what_the_kernel_cannot_take():
    x, m = _pool_case()
    tmp.check_pool_inputs("masked_pool", x, m)  # NCHW-contiguous: taken
    tmp.check_pool_inputs("masked_pool", x[:, :16], m)  # channel slice: batch/channel strides go to the kernel
    with pytest.raises(ValueError, match="contiguous H\\*W planes"):
        tmp.check_pool_inputs("masked_pool", x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), m)
    with pytest.raises(ValueError, match="contiguous H\\*W planes"):
        tmp.check_pool_inputs("masked_pool", x, m.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="m must be"):
        tmp.check_pool_inputs("masked_pool", x, m[:, :, :4])
    with pytest.raises(ValueError, match="m must be"):
        tmp.check_pool_inputs("masked_pool", x, m.expand(-1, 2, -1, -1))
    with pytest.raises(ValueError, match="m is torch.bfloat16"):  # mixed types: the caller casts the mask
        tmp.check_pool_inputs("masked_pool", x, m.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmp.check_pool_inputs("masked_pool", x.half(), m.half())
    with pytest.raises(ValueError, match="x must be"):
        tmp.check_pool_inputs("masked_pool", x[0], m)
    with pytest.raises(ValueError, match="empty"):
        tmp.check_pool_inputs("masked_pool", x[:, :0], m)
    with pytest.raises(ValueError, match="no kernel for device"):
        tmp.masked_pool(x.to("meta"), m.to("meta"))


# The masked pool's launch plan (CPU: plain Python). Shapes (B, C, N): the
# serving path's (B=8) and the train path's (B=16) at P3/P4/P5, and odd ones.
PLAN_SHAPES = {
    **{f"{p}_b{b}": (b, c, n) for b in (8, 16) for p, c, n in (("p3", 64, 6400), ("p4", 128, 1600), ("p5", 256, 400))},
    "p3_b1": (1, 64, 6400), "p5_b2": (2, 256, 400), "one_channel": (2, 1, 144), "c37_b16": (16, 37, 99),
    "c1024_b16": (16, 1024, 20), "b300_c64": (300, 64, 400), "b1_c4096": (1, 4096, 25),
}
KI = 4  # loads a thread has in flight (csrc/masked_reduce.cuh kI)


def _kernel_reads(B, C, N, tile, wpc, V):
    """How often csrc/masked_pool.cu reads each pixel of x (B, C, N) and
    counts each pixel of m into msum / cnt, per (image, tile) block, as its
    blocks, warps and reduce_row index them."""
    tiles = -(-C // tile)
    xs, ms = np.zeros((B, C, N), int), np.zeros((B, tiles, N), int)
    nt = 32 * wpc
    for blk in range(B * tiles):
        b, ct = divmod(blk, tiles)
        for warp in range(tmp.WARPS):
            s = warp % wpc
            for j in range(warp // wpc, tile, tmp.WARPS // wpc):
                c = ct * tile + j
                if c >= C:
                    continue
                for t in range(s * 32, s * 32 + 32):
                    for q0 in range(t * V, N, nt * V * KI):
                        for q in range(q0, min(q0 + nt * V * KI, N), nt * V):
                            xs[b, c, q:q + V] += 1
                            ms[b, ct, q:q + V] += j == 0
    return xs, ms


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_pool_plan_fills_the_card_and_covers_each_channel_once(shape, n_sm):
    """Every channel of every image falls in exactly one block; the warps per
    channel divide the block; the grid holds at most BLOCKS_PER_SM blocks
    per SM, and more than half that unless the tile cannot narrow (T = 1) or
    widen (C or MAX_TILE reached)."""
    B, C, N = PLAN_SHAPES[shape]
    tile, wpc, blocks = tmp.pool_plan(B, C, n_sm)
    assert tile & (tile - 1) == 0 and 1 <= tile <= tmp.MAX_TILE
    assert tmp.WARPS % wpc == 0 and (wpc == tmp.WARPS // tile if tile < tmp.WARPS else wpc == 1)
    assert tile * wpc <= 64  # the kernel's partial slots (kSlots)
    tiles = -(-C // tile)
    assert blocks == B * tiles
    owner = np.zeros((B, C), int)
    for blk in range(blocks):
        b, ct = divmod(blk, tiles)
        owner[b, ct * tile:(ct + 1) * tile] += 1
    assert (owner == 1).all()
    target = tmp.BLOCKS_PER_SM * n_sm
    widest = min(tmp.MAX_TILE, 1 << (C - 1).bit_length())
    assert blocks <= target or tile == widest
    assert tile == 1 or B * -(-C // (tile // 2)) > target  # the narrowest tile that fits
    if tile > 1 and tile < widest:
        assert blocks > target // 2


def test_pool_plan_at_the_serving_and_train_shapes():
    """On 132 SMs: two channels a block at P3, four at P4, eight at P5 for a
    batch of 8, twice as many for 16; 256 blocks each time."""
    for b, tiles in ((8, (2, 4, 8)), (16, (4, 8, 16))):
        for c, tile in zip((64, 128, 256), tiles):
            assert tmp.pool_plan(b, c, 132) == (tile, max(1, 8 // tile), 256)


@pytest.mark.parametrize("shape", [(2, 64, 64, 8), (2, 64, 35, 1), (3, 37, 25, 4), (16, 37, 99, 1),
                                   (2, 1, 16, 8), (16, 1024, 20, 4), (16, 256, 400, 8), (1, 64, 800, 8)],
                         ids=lambda s: "B{}_C{}_N{}_V{}".format(*s))
def test_pool_kernel_indexing_reads_each_pixel_once(shape):
    """The kernel's block / warp / thread indexing, replayed on the CPU: each
    pixel of x read once, each pixel of m counted once per block."""
    B, C, N, V = shape
    tile, wpc, _ = tmp.pool_plan(B, C, 132)
    xs, ms = _kernel_reads(B, C, N, tile, wpc, V)
    assert (xs == 1).all() and (ms == 1).all()


def _assert_reductions_close(got, want, n):
    for name, g, w in zip(("msum", "wsum", "gsum", "mmax", "cnt"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if name in ("mmax", "cnt"):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        else:
            torch.testing.assert_close(g / n, w / n, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_masked_reductions_kernel_matches_plain(card, case, dtype):
    x, m = (a.to(card, dtype) for a in _pool_case(**POOL_CASES[case]))
    before = tmr.launches
    got = tmr.masked_reductions(x, m)
    want = tmr.masked_reductions_ref(x, m)
    torch.cuda.synchronize()
    assert tmr.launches == before + 1
    _assert_reductions_close(got, want, x.shape[2] * x.shape[3])


@pytest.mark.cuda
def test_masked_reductions_kernel_on_a_channel_slice(card):
    x, m = (a.to(card, torch.bfloat16) for a in _pool_case(h=20, w=40, c=128, b=4, seed=50))
    xs = x[:, 32:96]
    _assert_reductions_close(tmr.masked_reductions(xs, m), tmr.masked_reductions_ref(xs, m), 800)


RED_CASES = {
    # the spatial mesh's bands of a 640 px image split in two (B=16): 40/20/10 rows of 80/40/20
    "band_p3": dict(b=16, h=40, w=80, c=64, seed=60),
    "band_p4": dict(b=16, h=20, w=40, c=128, seed=61),
    "band_p5": dict(b=16, h=10, w=20, c=256, seed=62),
    # the same bands of a 1280 px image: up to 25 16-byte loads a thread
    "band_1280_p3": dict(b=16, h=80, w=160, c=64, seed=74),
    "band_1280_p4": dict(b=16, h=40, w=80, c=128, seed=75),
    "odd_plane_41x43": dict(b=3, h=41, w=43, c=72, seed=63),  # rows not on 16 bytes: element loads
    "plane_over_a_stage": dict(b=2, h=160, w=160, c=8, seed=64),  # a row of eight warps, met in shared memory
    "bulk_chunks": dict(b=1, h=320, w=320, c=8, seed=76),  # bulk copies: planes of 7 chunks round the ring
    "bulk_groups": dict(b=300, h=256, w=264, c=1, seed=77),  # bulk copies: each block takes several groups
    "image_a_block": dict(b=300, h=3, w=5, c=8, seed=78),  # element loads: the images fill the card
    "few_groups": dict(b=1, h=40, w=80, c=16, seed=65),  # 16 groups of one channel: fewer than the SMs
    "two_groups_a_block": dict(b=16, h=10, w=20, c=600, seed=66),  # 38 channels a group, four threads a row
    "no_pixel": dict(kind="no_pixel", b=16, h=20, w=40, c=128, seed=67),
    "tiny": dict(kind="tiny", b=16, h=40, w=80, c=64, seed=68),
    "sparse_mask": dict(kind="sparse", b=4, h=10, w=20, c=256, seed=69),
}


def _red_case(kind="random", b=2, h=8, w=8, c=32, seed=0):
    """_pool_case, and a mask with m > 0.5 at a few pixels only ("sparse")."""
    x, m = _pool_case("random" if kind == "sparse" else kind, b, h, w, c, seed)
    if kind == "sparse":
        m = torch.from_numpy((np.random.default_rng(seed).uniform(0, 1, m.shape) > 0.995).astype(np.float32))
    return x, m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(RED_CASES))
def test_masked_reductions_kernel_at_the_band_shapes_and_edges(card, case, dtype):
    """The kernel against the plain version at the spatial mesh's band
    shapes of a 640 px and a 1280 px image, on rows not on 16 bytes, planes
    larger than a stage, fewer groups than SMs, several groups a block (on
    both routes), and no-pixel, tiny and sparse masks; the five outputs
    views of one allocation."""
    x, m = (a.to(card, dtype) for a in _red_case(**RED_CASES[case]))
    before = tmr.launches
    got = tmr.masked_reductions(x, m)
    torch.cuda.synchronize()
    assert tmr.launches == before + 1
    _assert_reductions_close(got, tmr.masked_reductions_ref(x, m), x.shape[2] * x.shape[3])
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("view", ["slice_aligned", "slice_unaligned", "offset_one"])
def test_masked_reductions_kernel_on_channel_slices(card, dtype, view):
    """Channels 8..39 of 48 with N = 800: every plane starts on 16 bytes
    (16-byte loads); channels 7..39 with N = 35 (a 5 x 7 plane): none does
    (element loads); and a contiguous tensor one element past a 16-byte
    boundary."""
    h, w, c0 = {"slice_aligned": (20, 40, 8), "slice_unaligned": (5, 7, 7), "offset_one": (20, 40, 0)}[view]
    x, m = (a.to(card, dtype) for a in _pool_case(b=4, h=h, w=w, c=48, seed=70))
    if view == "offset_one":
        buf = torch.empty(x.numel() + 1, device=card, dtype=dtype)
        x = buf[1:].view(x.shape).copy_(x)
    else:
        x = x[:, c0:40]
    aligned = tmr.tma_rows(x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0), h * w,
                           x.element_size())
    assert aligned == (view == "slice_aligned")
    _assert_reductions_close(tmr.masked_reductions(x, m), tmr.masked_reductions_ref(x, m), h * w)


@pytest.mark.cuda
def test_masked_reductions_kernel_under_graph_capture(card):
    """Ten calls captured in one CUDA graph, replayed on new inputs copied in
    place: each of the ten results equals the plain version."""
    x, m = (a.to(card, torch.bfloat16) for a in _pool_case(b=16, h=20, w=40, c=128, seed=71))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmr.masked_reductions(x, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tmr.launches
    with torch.cuda.graph(graph):
        outs = [tmr.masked_reductions(x, m) for _ in range(10)]
    assert tmr.launches == before + 10
    for seed in (72, 73):
        fresh = [a.to(card, torch.bfloat16) for a in _pool_case(b=16, h=20, w=40, c=128, seed=seed)]
        x.copy_(fresh[0])
        m.copy_(fresh[1])
        graph.replay()
        torch.cuda.synchronize()
        want = tmr.masked_reductions_ref(x, m)
        for got in outs:
            _assert_reductions_close(got, want, 800)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["band_p3", "odd_plane_41x43", "bulk_chunks"])
def test_masked_reductions_kernel_is_one_launch_and_one_device_kernel(card, case):
    """One launch counted and one device kernel a call (torch.profiler over
    five calls), on each route: into registers 16 bytes or one element a
    load, and the bulk copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, m = (a.to(card, torch.bfloat16) for a in _red_case(**RED_CASES[case]))
    tmr.masked_reductions(x, m)
    torch.cuda.synchronize()
    before = tmr.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tmr.masked_reductions(x, m)
        torch.cuda.synchronize()
    assert tmr.launches == before + 5
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in rows) == 5, [(e.key, e.count) for e in rows]


def test_masked_reductions_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain twin (no launch); the checks refuse what
    the kernel cannot take before any launch."""
    x, m = _pool_case(seed=51)
    before = tmr.launches
    got, want = tmr.masked_reductions(x, m), tmr.masked_reductions_ref(x, m)
    assert tmr.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[3].shape == (x.shape[0], x.shape[1]) and got[0].shape == got[4].shape == (x.shape[0], 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tmr.masked_reductions(x.to("meta"), m.to("meta"))
