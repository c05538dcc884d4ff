"""PyTorch port, the masked reductions' launch plan and layout on the CPU.

``ops/masked_reductions.py`` ``reductions_plan`` picks a route for
``csrc/masked_reductions.cu`` (rows straight into registers, or TMA bulk
copies into a ring of shared-memory stages) and cuts a call into groups of
channel rows, chunks and stages. The ring's byte arithmetic (its
``Layout``, the producer's copies and ``expect_tx``, the consumers' warp and
lane indexing) is replayed here from the plan by a mirror of the kernel's
walk, since the kernel itself runs only on the card. A wrong byte count
there hangs the kernel rather than failing, so it is checked here, where
nothing hangs. The plain version's buffers are checked too: the five
outputs are views of one allocation on both routes.
"""

import itertools
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mga_yolo_tpu_torch.ops import masked_reductions as tmr

N_SM = 132  # an H100 SXM

BANDS = {"p3": (16, 64, 40 * 80), "p4": (16, 128, 20 * 40), "p5": (16, 256, 10 * 20)}  # (B, C, N) at 640 px / 2
SHAPES = {
    **{f"band_{k}": v for k, v in BANDS.items()},
    "serve_p3": (8, 64, 80 * 80),
    "odd_plane": (3, 72, 41 * 43),
    "plane_over_a_stage": (2, 8, 160 * 160),
    "whole_640": (1, 8, 640 * 640),
    "few_groups": (1, 16, 40 * 80),
    "one_channel": (2, 1, 9 * 16),
    "wide_c": (16, 1024, 4 * 5),
    "c600": (16, 600, 10 * 20),
    "c37": (16, 37, 9 * 11),
    "plane_1": (4, 32, 1),
    "plane_5x5": (2, 16, 25),
}
ITEMSIZES = {"f32": 4, "bf16": 2}
REPLAYED = [k for k, (B, C, N) in SHAPES.items() if B * C * N <= 400_000]  # the lane replay is slow in Python


# The kernel's walk, mirrored from csrc/masked_reductions.cu for the checks
# below: Groups (a block's groups, found without a division), produce (the
# copies in the order the consumers take them, with the bytes each full
# barrier is armed with) and the consumers' indexing. The kernel runs only
# on the card; a wrong byte count there hangs rather than fails.


def group_channels(k, C, q):
    """Group k's first channel and its channels (Groups::at): C = q gsz +
    grem, the first grem groups of gsz + 1 channels, then groups of gsz."""
    gsz, grem = divmod(C, q)
    return k * gsz + min(k, grem), gsz + (k < grem)


def first_group(block, q):
    """Block ``block``'s first group (the Groups constructor): (image, k)
    from ``(block + 0.5) * (1 / q)`` in float32, truncated."""
    b = int((np.float32(block) + np.float32(0.5)) * (np.float32(1) / np.float32(q)))
    return b, block - b * q


class Unit(NamedTuple):
    """A chunk of a group, whose mask chunk goes to slot ``u % 2``."""

    u: int
    b: int
    c0: int
    g: int
    first: bool
    p0: int
    n_px: int


class Item(NamedTuple):
    """Rows [r0, r0 + r) of a unit's group, into stage ``n % S``."""

    n: int
    unit: Unit
    r0: int
    r: int


def block_walk(plan, B, C, N, block):
    """The units and items block ``block`` takes, in the order produce
    issues their copies and the consumers take them."""
    n = u = 0
    for gi in range(block, B * plan.q, plan.grid):
        b, k = divmod(gi, plan.q)
        c0, g = group_channels(k, C, plan.q)
        for ch in range(plan.nch):
            p0 = ch * plan.L
            unit = Unit(u, b, c0, g, k == 0, p0, min(plan.L, N - p0))
            yield unit
            for r0 in range(0, g, plan.R):
                yield Item(n, unit, r0, min(plan.R, g - r0))
                n += 1
            u += 1


def prologue_length(plan, walk):
    """How many of the walk's first elements thread 0 issues before the
    block's first barrier (produce<kPrologue>): those up to the first that
    waits on a slot or a stage (unit u >= 2, item n >= S)."""
    for i, el in enumerate(walk):
        if (el.u >= 2) if isinstance(el, Unit) else (el.n >= plan.S):
            return i
    return len(walk)


def copies(plan, el, itemsize, x_sb, x_sc, m_sb):
    """produce's copies of a unit or an item: (tensor, element offset,
    shared-memory byte offset, bytes); an item's rows as one copy where they
    are consecutive in memory and in the stage."""
    if isinstance(el, Unit):
        return [("m", el.b * m_sb + el.p0, plan.S * plan.stage + (el.u % 2) * plan.pitch, el.n_px * itemsize)]
    u = el.unit
    src = u.b * x_sb + (u.c0 + el.r0) * x_sc + u.p0
    dst = (el.n % plan.S) * plan.stage
    nbytes = u.n_px * itemsize
    if x_sc == u.n_px and nbytes == plan.pitch:
        return [("x", src, dst, el.r * nbytes)]
    return [("x", src + j * x_sc, dst + j * plan.pitch, nbytes) for j in range(el.r)]


def expect_tx(el, itemsize):
    """The bytes produce arms a unit's or an item's full barrier with:
    ``row_bytes`` and ``r * row_bytes``."""
    return el.n_px * itemsize if isinstance(el, Unit) else el.r * el.unit.n_px * itemsize



def _plan(shape, isz, aligned=True, n_sm=N_SM):
    B, C, N = shape
    return tmr.reductions_plan(B, C, N, isz, n_sm, aligned)


def _walks(plan, B, C, N):
    return {blk: list(block_walk(plan, B, C, N, blk)) for blk in range(plan.grid)}


def _items(walk):
    return [el for el in walk if isinstance(el, Item)]


@pytest.mark.parametrize("isz", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_every_row_lies_in_one_group_and_every_mask_is_counted_once(name, isz):
    """Over all blocks' items: each pixel of each (image, channel) row
    copied once; each image's mask pixels counted once (row 0 of the first
    item of each chunk of the image's first group); groups of about equal
    channels."""
    B, C, N = SHAPES[name]
    plan = _plan(SHAPES[name], isz)
    xs = np.zeros((B, C, N), int)
    ms = np.zeros((B, N), int)
    groups = set()
    for walk in _walks(plan, B, C, N).values():
        for it in _items(walk):
            u = it.unit
            assert 1 <= it.r <= plan.R and u.g <= plan.gmax and u.c0 + it.r0 + it.r <= C
            xs[u.b, u.c0 + it.r0:u.c0 + it.r0 + it.r, u.p0:u.p0 + u.n_px] += 1
            if u.first and it.r0 == 0:
                assert u.c0 == 0
                ms[u.b, u.p0:u.p0 + u.n_px] += 1
            groups.add((u.b, u.c0, u.g))
    assert (xs == 1).all() and (ms == 1).all()
    assert len(groups) == B * plan.q
    sizes = [g for _, _, g in groups]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("isz", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_stages_fit_and_expect_tx_equals_the_copied_bytes(name, isz):
    """The ring, the mask slots, the barriers and the partials fit in 227
    KB; each element's copies land inside its stage or mask slot, 16-byte
    aligned, on rows of their own; the bytes its full barrier is armed with
    equal the bytes copied; items go round the ring in order."""
    B, C, N = SHAPES[name]
    plan = _plan(SHAPES[name], isz)
    lay = tmr.layout(C, plan.q, N, plan.L, plan.R, plan.S, plan.M, isz)
    assert (lay["gmax"], lay["tpc"], lay["spr"], lay["pitch"], lay["stage"]) == (
        plan.gmax, plan.tpc, plan.spr, plan.pitch, plan.stage)
    assert plan.smem == (lay["bytes"] if plan.route == tmr.BULK else 0)
    assert plan.smem <= tmr.MAX_SMEM == 232448
    assert plan.pitch % 16 == 0 and plan.stage == plan.R * plan.pitch and lay["bar_off"] % 8 == 0
    assert plan.tpc * plan.R <= tmr.CONSUMERS and plan.tpc & (plan.tpc - 1) == 0
    assert lay["direct"] == (plan.nch == 1 and plan.tpc <= 32)
    assert plan.smem <= (tmr.BLOCK_SMEM if plan.grid > N_SM else tmr.MAX_SMEM) or plan.S == 1
    assert 1 <= plan.S <= tmr.MAX_STAGES and 1 <= plan.L <= N and plan.nch == -(-N // plan.L)
    assert plan.grid == (min(B * plan.q, tmr.BLOCKS_PER_SM * N_SM) if plan.route == tmr.BULK else B * plan.q)
    units = max(sum(isinstance(el, Unit) for el in w) for w in _walks(plan, B, C, N).values())
    assert plan.M == min(2, units)
    x_sb, x_sc, m_sb = C * N, N, N
    for walk in _walks(plan, B, C, N).values():
        ns = [it.n for it in _items(walk)]
        assert ns == list(range(len(ns)))
        for el in walk:
            cps = copies(plan, el, isz, x_sb, x_sc, m_sb)
            assert sum(c[3] for c in cps) == expect_tx(el, isz)
            if isinstance(el, Unit):
                assert el.u % 2 < plan.M
                lo, hi = lay["mask_off"] + (el.u % 2) * plan.pitch, lay["mask_off"] + (el.u % 2 + 1) * plan.pitch
            else:
                lo, hi = (el.n % plan.S) * plan.stage, (el.n % plan.S + 1) * plan.stage
                assert len(cps) in (1, el.r)
            for _, _, dst, nbytes in cps:
                assert lo <= dst and dst + nbytes <= hi and dst % 16 == 0
                assert nbytes % 16 == 0 or N * isz % 16


@pytest.mark.parametrize("name", REPLAYED)
def test_threads_reduce_each_element_once(name):
    """The consumers' indexing replayed: thread t takes row t // tpc of an
    item (on the registers' route, of each pass of CONSUMERS // tpc rows of
    the block's group), part t % tpc: its 16-byte vectors, then the ragged
    tail's elements; each element of each row reduced once, the mask counted
    once (row 0 of a first group's first item), and the threads of a row
    meet within one warp (tpc <= 32) or a whole warp at a time; where a
    plane is one chunk, one warp holds each row (its first lane writes the
    channel)."""
    B, C, N = SHAPES[name]
    isz = 2
    V = 16 // isz
    plan = _plan(SHAPES[name], isz)
    tpc = plan.tpc
    assert tpc <= 32 and 32 % tpc == 0 or tpc % 32 == 0
    rows = plan.R if plan.route == tmr.BULK else tmr.CONSUMERS // tpc
    for walk in _walks(plan, B, C, N).values():
        units = [el for el in walk if isinstance(el, Unit)]
        passes = ([(u, r0, min(rows, u.g - r0)) for u in units for r0 in range(0, u.g, rows)]
                  if plan.route != tmr.BULK else [(it.unit, it.r0, it.r) for it in _items(walk)])
        for unit, r0, r in passes:
            n_px = unit.n_px
            seen = np.zeros((r, n_px), int)
            mask = np.zeros(n_px, int)
            nv = n_px // V
            for t in range(tmr.CONSUMERS):
                rho, sub = divmod(t, tpc)
                if rho >= r:
                    continue
                idx = [e for v in range(sub, nv, tpc) for e in range(v * V, v * V + V)]
                idx += list(range(nv * V + sub, n_px, tpc))
                seen[rho, idx] += 1
                if unit.first and r0 == 0 and rho == 0:
                    mask[idx] += 1
            assert (seen == 1).all()
            assert (mask == (1 if unit.first and r0 == 0 else 0)).all()


@pytest.mark.parametrize("isz", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_the_registers_route_is_taken_where_a_thread_has_a_few_loads(name, isz):
    """VECTORS (the registers' route, 16-byte loads) exactly where the rows
    are on 16 bytes and each thread of a row has at most REGISTER_LOADS of
    its 16-byte vectors (tpc for the group's rows at once); then a block a
    group, no shared memory, one chunk, and where a row takes several warps,
    the group's rows in one pass. ELEMENTS (the registers' route, one
    element a load) wherever the rows are not on 16 bytes."""
    B, C, N = SHAPES[name]
    V = 16 // isz
    aligned = N % V == 0  # contiguous tensors on 16 bytes: tma_rows holds where a row is a multiple of 16 bytes
    plan = _plan(SHAPES[name], isz, aligned=aligned)
    R = min(plan.gmax, tmr.CONSUMERS)  # the route's rows a pass: the group's, all at once where they fit
    tpc = tmr.layout(C, plan.q, N, N, R, 1, 1, isz)["tpc"]
    fits = aligned and -(-(N // V) // tpc) <= tmr.REGISTER_LOADS
    assert (plan.route == tmr.VECTORS) == fits
    assert plan.route in ((tmr.VECTORS, tmr.BULK) if aligned else (tmr.ELEMENTS,))
    if plan.route != tmr.BULK:
        assert plan.smem == 0 and (plan.L, plan.nch, plan.R, plan.tpc, plan.S, plan.M) == (N, 1, R, tpc, 1, 1)
        assert plan.grid == B * plan.q
        assert plan.tpc <= 32 or plan.R * plan.tpc <= tmr.CONSUMERS  # several warps a row: one pass
    assert _plan(SHAPES[name], isz, aligned=False).route == tmr.ELEMENTS


class _Barrier:
    """An mbarrier: ``count`` arrivals and the announced bytes complete a
    phase; ``try_wait(parity)`` passes once the phase of that parity is
    complete, that is while the phase in progress has the other parity."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.completed = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.count

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        assert self.pending >= 0
        self._check()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

    def try_wait(self, parity, phase):
        ok = self.completed % 2 != parity
        if ok:
            assert self.completed > phase, "a wait passed on an older phase of the same parity"
        return ok


def _simulate(plan, walk, seed):
    """The kernel's protocol on one block: thread 0's prologue, then the
    producer's rest (waiting on empty stages and mask slots), the copies
    landing later in random order, and 8 consumer warps that wait for full
    stages and slots, read them over several steps and release them, in a
    random interleaving. Fails on a deadlock (a hang on the card), on a
    wait passing on the wrong phase, and on a stage or slot overwritten
    before every warp has read it."""
    rng = np.random.default_rng(seed)
    S = plan.S
    full, empty = [_Barrier(1) for _ in range(S)], [_Barrier(tmr.WARPS) for _ in range(S)]
    mfull, mempty = [_Barrier(1) for _ in range(2)], [_Barrier(tmr.WARPS) for _ in range(2)]
    content = {}   # ("s", stage) / ("m", slot) -> the element whose copy landed there last
    inflight = []  # copies not yet landed: (key, element id, barrier, bytes)
    n_pro = prologue_length(plan, walk)

    def key_bar(el):
        return (("m", el.u % 2), mfull[el.u % 2]) if isinstance(el, Unit) else (("s", el.n % S), full[el.n % S])

    def issue(el):
        key, bar = key_bar(el)
        bar.arrive(tx=expect_tx(el, 2))
        inflight.append((key, id(el), bar, expect_tx(el, 2)))

    for el in walk[:n_pro]:
        issue(el)

    def producer():
        for el in walk[n_pro:]:
            if isinstance(el, Unit):
                if el.u >= 2:
                    while not mempty[el.u % 2].try_wait((el.u // 2 - 1) % 2, el.u // 2 - 1):
                        yield
            elif el.n >= S:
                while not empty[el.n % S].try_wait((el.n // S - 1) % 2, el.n // S - 1):
                    yield
            issue(el)
            yield

    def consumer():
        unit = None
        for el in walk:
            if isinstance(el, Unit):
                if unit is not None:
                    mempty[unit.u % 2].arrive()
                unit = el
                while not mfull[el.u % 2].try_wait((el.u // 2) % 2, el.u // 2):
                    yield
                assert content[("m", el.u % 2)] == id(el)
                continue
            while not full[el.n % S].try_wait((el.n // S) % 2, el.n // S):
                yield
            for _ in range(2):  # the read spans steps: nothing may land over it meanwhile
                assert content[("s", el.n % S)] == id(el) and content[("m", unit.u % 2)] == id(unit)
                yield
            empty[el.n % S].arrive()
        if unit is not None:
            mempty[unit.u % 2].arrive()

    agents = [producer()] + [consumer() for _ in range(tmr.WARPS)]
    live = list(range(len(agents)))
    stalls = 0
    while live or inflight:
        if inflight and (not live or rng.random() < 0.3):
            key, ident, bar, nbytes = inflight.pop(int(rng.integers(len(inflight))))
            content[key] = ident
            bar.complete_tx(nbytes)
            stalls = 0
            continue
        i = live[int(rng.integers(len(live)))]
        try:
            next(agents[i])
        except StopIteration:
            live.remove(i)
        stalls += 1
        assert stalls < 10_000, "deadlock: every agent waits and no copy is in flight"
    assert all(b.pending == b.count and b.tx == 0 for b in full + empty + mfull + mempty)


SIM = {
    **{k: SHAPES[k] for k in ("band_p3", "band_p4", "band_p5", "odd_plane", "plane_over_a_stage", "c600")},
    "two_groups_a_block": (16, 64, 40 * 80),
}


@pytest.mark.parametrize("n_sm", [132, 7, 2], ids=lambda n: f"sm{n}")
@pytest.mark.parametrize("name", list(SIM))
def test_the_ring_protocol_neither_hangs_nor_overwrites(name, n_sm):
    """The mbarrier protocol simulated on the busiest block of each plan,
    on 132 SMs and on 7 and 2 (several groups a block: the ring and the
    mask slots go round many times), in five random interleavings."""
    B, C, N = SIM[name]
    plan = _plan(SIM[name], 2, n_sm=n_sm)
    if plan.route != tmr.BULK:  # no ring: no barrier, no copy
        assert plan.smem == 0 and plan.grid == B * plan.q
        return
    walk = max(_walks(plan, B, C, N).values(), key=len)
    for seed in range(5):
        _simulate(plan, walk, seed)


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("isz", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
def test_band_shapes_give_every_sm_the_same_bytes_within_one_group(band, isz):
    """At the band shapes on 132 SMs (two blocks an SM, block i on SM
    i % 132 as the card hands them out): the bytes an SM copies, the masks'
    included, differ by at most one group's; sixteen groups an image, one a
    block, 256 blocks."""
    B, C, N = BANDS[band]
    plan = _plan(BANDS[band], isz)
    per_sm = [0] * N_SM
    for blk, walk in _walks(plan, B, C, N).items():
        per_sm[blk % N_SM] += sum(expect_tx(el, isz) for el in walk)
    assert max(per_sm) - min(per_sm) <= (plan.gmax + 1) * N * isz
    assert (plan.q, plan.grid) == (16, 256)


def test_band_plans():
    """The band shapes' plans in bfloat16, of a 640 px image and of a 1280
    px one: 16 groups an image of 4 / 8 / 16 channels, 256 blocks, on the
    registers' route (16-byte loads, no shared memory): 64 threads a row at
    P3 (two warps, which meet in shared memory), 32 at P4, 16 at P5, so
    every thread of a block is busy; at most 7 (640 px) and 25 (1280 px)
    vectors a thread. Twice the rows of a 2560 px image's P3 band go by
    bulk copies, in chunks of a stage, four stages, two blocks an SM."""
    for scale, most in ((1, 7), (2, 25)):
        got = [_plan((B, C, N * scale * scale), 2) for B, C, N in BANDS.values()]
        assert [(p.q, p.grid, p.gmax, p.R, p.tpc, p.smem, p.route) for p in got] == [
            (16, 256, 4, 4, 64, 0, tmr.VECTORS), (16, 256, 8, 8, 32, 0, tmr.VECTORS),
            (16, 256, 16, 16, 16, 0, tmr.VECTORS)]
        assert max(-(-(N * scale * scale // 8) // p.tpc) for (B, C, N), p in zip(BANDS.values(), got)) == most
    p = _plan((16, 64, 160 * 320), 2)
    assert (p.route, p.grid, p.R, p.tpc, p.S, p.M, p.L, p.nch) == (tmr.BULK, 256, 4, 64, 4, 2, 2048, 25)
    assert 2 * (p.smem + 1024) <= 228 * 1024 and p.stage == tmr.STAGE_BYTES


def test_the_ring_takes_large_planes_in_items_of_the_groups_rows():
    """On the bulk-copy route an item holds all the rows of its group (R =
    gmax, at most CONSUMERS) over a chunk of pixels, so each consumer
    thread keeps one row's partials over the chunks; stages of STAGE_BYTES,
    twice that where a block has its SM alone (grid <= n_sm)."""
    for shape in [(16, 64, 160 * 320), (1, 8, 320 * 320), (2, 3, 400 * 400), (16, 600, 100 * 100)]:
        p = _plan(shape, 2)
        assert p.route == tmr.BULK and p.R == min(p.gmax, tmr.CONSUMERS)
        assert p.stage <= tmr.STAGE_BYTES * (2 if p.grid <= N_SM else 1)
        assert p.L == shape[2] or p.stage > tmr.STAGE_BYTES * (2 if p.grid <= N_SM else 1) // 2 - 16 * p.R
        assert tmr.layout(shape[1], p.q, shape[2], p.L, p.R, p.S, p.M, 2)["direct"] == (p.tpc <= 32)


def test_where_the_images_fill_the_card_a_group_is_an_image():
    """With B at least two blocks an SM, q = 1 (at most MAX_GROUP channels
    a group): a block an image, as many blocks as images."""
    for B, C, N in [(264, 8, 32), (300, 8, 32), (300, 2048, 16)]:
        p = _plan((B, C, N), 2)
        assert p.q == -(-C // tmr.MAX_GROUP) and p.grid == B * p.q and p.route == tmr.VECTORS


@pytest.mark.parametrize("isz", [2, 4])
def test_tma_eligibility_is_the_alignment_rule(isz):
    """``tma_rows`` holds exactly when every copy of the plan starts on 16
    bytes in memory and moves a multiple of 16 bytes (two images, several
    groups: every stride is used)."""
    rng = np.random.default_rng(0)
    for ptr_off, m_off, N, extra_c, extra_b in itertools.product((0, 2, 4, 8), (0, 4), (8, 35, 64, 200), (0, 1, 8),
                                                                   (0, 2)):
        B, C = 2, 6
        x_sc = N + extra_c
        x_sb = C * x_sc + extra_b
        m_sb = N + extra_b
        x_ptr, m_ptr = 4096 + ptr_off * isz // 2, 8192 + m_off
        rule = tmr.tma_rows(x_ptr, m_ptr, x_sb, x_sc, m_sb, N, isz)
        plan = tmr.reductions_plan(B, C, N, isz, int(rng.integers(2, 6)), rule)
        ok = True
        for walk in _walks(plan, B, C, N).values():
            for el in walk:
                for kind, off, _, nbytes in copies(plan, el, isz, x_sb, x_sc, m_sb):
                    base = x_ptr if kind == "x" else m_ptr
                    ok &= (base + off * isz) % 16 == 0 and nbytes % 16 == 0
        assert rule == ok, (ptr_off, m_off, N, extra_c, extra_b)
        assert plan.route in ((tmr.BULK, tmr.VECTORS) if rule else (tmr.ELEMENTS,))


@pytest.mark.parametrize("q", [1, 2, 3, 7, 8, 16, 36, 64, 75, 127, 128, 509, 1000, 1024])
def test_a_blocks_first_group_is_found_without_a_division(q):
    """The kernel's first group of block i, (i + 0.5) * (1 / q) in float32
    truncated, equals i // q for every block of a call (B q <= MAX_GROUPS)."""
    blocks = np.arange(tmr.MAX_GROUPS, dtype=np.int64)
    got = ((blocks.astype(np.float32) + np.float32(0.5)) * (np.float32(1) / np.float32(q))).astype(np.int64)
    assert (got == blocks // q).all()
    assert all(first_group(i, q) == divmod(i, q) for i in (0, q - 1, q, tmr.MAX_GROUPS - 1))


def test_plan_caps_the_group_and_is_cached():
    """At most MAX_GROUP channels a group; one plan object a shape."""
    plan = tmr.reductions_plan(1, 4096, 4, 2, N_SM, True)
    assert plan.gmax <= tmr.MAX_GROUP and plan.smem <= tmr.MAX_SMEM
    assert tmr.reductions_plan(16, 64, 3200, 2, N_SM, True) is tmr.reductions_plan(16, 64, 3200, 2, N_SM, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_five_outputs_are_views_of_one_buffer(dtype):
    """On the CPU (the plain version): msum | wsum | gsum | cnt are the
    columns of one (B, 2C + 2) buffer and mmax (B, C) follows it in the
    same allocation, so the mesh all-reduces the sums without a copy."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 4, 6)).astype(np.float32)).to(dtype)
    m = torch.from_numpy(rng.uniform(0, 1, (3, 1, 4, 6)).astype(np.float32)).to(dtype)
    sums, mmax = tmr.reduction_buffers(x, m)
    assert sums.shape == (3, 12) and mmax.shape == (3, 5) and sums.is_contiguous() and mmax.is_contiguous()
    assert sums.untyped_storage().data_ptr() == mmax.untyped_storage().data_ptr()
    assert mmax.data_ptr() == sums.data_ptr() + sums.numel() * 4
    got = tmr.masked_reductions(x, m)
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    msum, wsum, gsum, mx, cnt = got
    assert [t.shape for t in got] == [(3, 1), (3, 5), (3, 5), (3, 5), (3, 1)]
    assert msum.data_ptr() == got[0].untyped_storage().data_ptr() + msum.storage_offset() * 4
    x32, m32 = x.float().reshape(3, 5, -1), m.float().reshape(3, 1, -1)
    torch.testing.assert_close(wsum, (x32 * m32).sum(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gsum, x32.sum(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(msum, m32.sum(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cnt, (m32 > 0.5).float().sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(mx, torch.where(m32 > 0.5, x32, -3.0e38).amax(-1), rtol=0, atol=0)
    for t, col in ((msum, 0), (wsum, 1), (gsum, 6), (cnt, 11)):
        torch.testing.assert_close(t, sums[:, col:col + t.shape[1]], rtol=0, atol=0)
