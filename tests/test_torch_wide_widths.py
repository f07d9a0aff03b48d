"""The last shape gaps of the TPU kernels on the CPU (ROADMAP.md K5, K6b):
the SA stage at any width up to 2048 channels and the match chain up to
256 channels and 16 heads.

Here:
  - the SA wrapper's padded layout (kernels/sa_stage.pad_args: zeros in
    the lanes past C) through the plain version equals the unpadded plain
    version bit for bit, and a model of the float32 kernel's
    h1-from-gather layout (16-row blocks, each centre's max stored whole or
    met by a max into zeros) meets the plain version; the plans of both SA
    kernels at the new widths;
  - kernels/match_grid.plan at every new width, head count, head and
    dtype, and its refusal past the new bound naming ROADMAP.md's K7;
  - the rows tier's wide kernel (C = 256, csrc/match_rows_wg.cuh
    rows_wide_kernel): its stage copies (weights, and the A stages of its
    scratch rows) read back byte for byte, and a model of its walk (the
    producer's stage order, each scratch stage read as it stood at the
    event the producer waited for, every output in 128-column groups, the
    message over its heads' band, LayerNorm from Chan-merged halves, the
    summary's k and v once a tile and KV over the diagonal units only,
    written as the other side's message stages) against the plain chain,
    exact and padded, at both dtypes; the exact C = 128 instantiation's
    walk at 16 heads of 8 channels;
  - the port at configs/widths.py's conv_out256, heads16, mul16 and
    image256 (at the tiny test widths of their other dimensions) against
    JAX's model.apply and its scorers' grid and pairs, with the same
    converted weights. (The four --set lists' parameter trees against
    JAX's: tests/test_torch_match_widths.py::
    test_width_set_lines_build_the_same_tree, which takes every WIDTHS
    entry.)
The card holds the kernels themselves to the plain version at these shapes
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 17)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.configs import models as jmodels  # noqa: E402
from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu_torch import configs as tcfg  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import sa_stage as sa  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_match import inputs  # noqa: E402
from tests._torch_image import images, jax_variables_of  # noqa: E402
from tests._torch_port import TINY, crops  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_torch_match_rows_plan import (  # noqa: E402
    _kernel_model, _offset, read_stage)
from tests.test_torch_match_widths import _image_cfg  # noqa: E402

BF16 = torch.bfloat16
# the models of the kernels' walks in float64 against the plain chain
# (float32; bf16 with its rounded operands), relative to max(1, |plain|),
# as tests/test_torch_match_rows_plan.py holds the chain's walk
WALK_TOL = {torch.float32: 1e-5, BF16: 1e-2}
# the float32 SA kernel's model in float64 against the plain version
SA_MODEL_TOL = 1e-5
# the JAX suite's bars (tests/test_torch_match_widths.py): the model through
# a converter; the grid and pair chains
MODEL_TOL = 1e-3
GRID_RTOL, GRID_ATOL = 2e-4, 2e-5


# ---- the SA stage at any width up to 2048 (K5) ------------------------------------

def _sa_args(B, N, S, K, C, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    return (r(B, N, C).to(dtype), r(B, S, C).to(dtype), idx,
            r(C, C) / C ** 0.5, r(C, C) / C ** 0.5) + tuple(
                r(C) for _ in range(6))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("C", [16, 48, 1056])
def test_sa_padded_layout_is_exact(C, dtype):
    """pad_args at kernel_width(C) (32, 64; 1,056 is a kernel width and
    passes unchanged): the plain version on the padded arguments equals
    the unpadded plain version bit for bit on the true lanes, and the
    padded lanes are exactly 0 (relu(0 * s + 0) through all three convs,
    exact zeros in every sum, a max of zeros)."""
    args = _sa_args(2, 40, 8, 5, C, seed=C, dtype=dtype)
    W = sa.kernel_width(C)
    assert W == max(32, -(-C // 32) * 32)
    padded = sa.pad_args(*args, W)
    assert [x.shape[-1] for x in padded if x.dim() != 3 or x is padded[0]
            or x is padded[1]] == [W] * 10
    assert padded[3].is_contiguous() and padded[4].is_contiguous()
    want = sa.sa_convmax_reference(*args)
    got = sa.sa_convmax_reference(*padded)
    assert torch.equal(got[..., :C], want)
    assert not got[..., C:].float().any()
    # the weights' padded copy is made once per weight tensor
    assert sa.pad_args(*args, W)[3] is padded[3]


def _gather_model(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3):
    """The float32 kernel's h1-from-gather layout in float64
    (csrc/sa_stage.cu sa_convmax_gather_kernel): the R = B S K rows in
    blocks of 16; conv2 from the gather, conv3 into the strip, each
    column's max over each centre's rows in the block, stored where the
    centre lies whole in the block, else a max into the zero-filled out."""
    B, S, K = idx.shape
    N, C = A.shape[1:]
    R = B * S * K
    rows = torch.arange(R)
    centre = rows // K
    src = (centre // S) * N + idx.reshape(-1).long()
    h = (A.reshape(-1, C)[src].double() + Ct.reshape(-1, C)[centre].double())
    h = torch.relu(h * s1.double() + t1.double())
    h = torch.relu(h @ w2.double() * s2.double() + t2.double())
    h = torch.relu(h @ w3.double() * s3.double() + t3.double())
    out = torch.zeros(B * S, C, dtype=torch.float64)
    for r0 in range(0, R, 16):
        hi = min(r0 + 16, R)
        for ce in range(r0 // K, (hi - 1) // K + 1):
            lo_r, hi_r = max(ce * K, r0), min((ce + 1) * K, hi)
            m = h[lo_r:hi_r].amax(0).clamp(min=0)
            whole = ce * K >= r0 and (ce + 1) * K <= hi
            out[ce] = m if whole else torch.maximum(out[ce], m)
    return out.reshape(B, S, C)


@pytest.mark.parametrize("B,S,K", [(2, 8, 48), (3, 5, 20), (2, 7, 5),
                                   (1, 3, 16)])
def test_sa_gather_layout_model_meets_the_plain_version(B, S, K):
    """At C = 2048 the float32 kernel takes the h1-from-gather layout (M =
    16 rows, 16 warps, h2 buffer and strips in 164,096 bytes); a model of
    its blocks and of its maxima (K = 48 and 16 whole in blocks, K = 20
    and 5 straddling them, a ragged last block) meets the plain version."""
    C = 2048
    how = sa.plan_f32(C, K)
    assert how == sa.SaF32Plan(sa.GATHER_H1, 16, 4, 16, 164096, K == 16)
    args = _sa_args(B, 30, S, K, C, seed=K)
    want = sa.sa_convmax_reference(*args).double()
    got = _gather_model(*args)
    assert (got - want).abs().max() <= SA_MODEL_TOL * max(
        1.0, want.abs().max())


def test_sa_plans_past_1024_channels():
    """The float32 kernel: two buffers of M rows to 1,792 channels (M = 16
    from 1,056), the h1-from-gather layout past them, within a block's
    shared memory at every multiple of 32; the bf16 kernel: its mma_sync
    tier past 1024 (the wgmma tier's h2 would not fit), M = 16 at 2048 in
    131,584 bytes. Past 2048 both raise naming ROADMAP.md's K7."""
    for W in range(32, 2049, 32):
        how = sa.plan_f32(W, 48)
        assert how.smem <= sa.MAX_SMEM
        assert how.layout == (sa.GATHER_H1 if W > 1792 else sa.TWO_BUFFERS)
        if W > 1024:
            assert (how.warps, how.nt, how.tile_rows) == (16, 4, 16)
            assert sa.plan_bf16(W, 48).tier == sa.MMA_SYNC
    assert sa.plan_f32(1792, 48).smem == 2 * 16 * 1796 * 4
    assert sa.plan_bf16(2048, 48) == sa.SaPlan(sa.MMA_SYNC, 16, 0, 1, 0,
                                               131584, False)
    assert [sa.kernel_width(C) for C in (1, 16, 33, 1025, 2047, 2048)] == [
        32, 32, 64, 1056, 2048, 2048]
    for C in (2049, 4096):
        with pytest.raises(ValueError, match="K7"):
            sa.kernel_width(C)
    with pytest.raises(NotImplementedError, match="K7"):
        sa.plan_bf16(2080, 48)


# ---- the match chain to 256 channels and 16 heads (K6b) ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("pos", [True, False])
def test_plan_takes_every_width_to_256_channels_and_16_heads(pos, dtype):
    """A tier for every C from 129 to 256 in up to 16 heads (the rows tier's
    wide kernel, at 256, its bytes those of one head's layout), and for 9
    to 16 heads at every width they divide (the rows tier wherever the
    cluster tier's layout does not fit); the padded entry points where
    rows_padded says. Past 256 channels, or 16 heads where the rows tier
    is needed, ValueError naming ROADMAP.md's K7."""
    wide = mg.rows_layout(256, 1, dtype).smem
    for C in range(129, 257):
        for H in (h for h in range(1, 17) if C % h == 0):
            for N in (1, 128, 197, 2048):
                assert mg.plan(N, C, H, pos=pos, dtype=dtype) == mg.Plan(
                    mg.ROWS, wide)
                assert mg.rows_padded(C, H, 5 if pos else 4)
    bf16 = dtype == BF16
    for C in range(9, 129):
        for H in (h for h in range(9, 17) if C % h == 0):
            for N in (128, 2048, 5000):
                how = mg.plan(N, C, H, pos=pos, dtype=dtype)
                if how.tier == mg.CLUSTER:      # any heads at C <= 64
                    assert C <= 64 and how.smem == (
                        mg.cluster_bytes_bf16 if bf16 else mg.cluster_bytes)(
                            N, mg.kernel_width(C, mg.CLUSTER))
                    continue
                W = mg.kernel_width(C, mg.ROWS)
                assert how == mg.Plan(mg.ROWS, mg.rows_layout(W, H, dtype)
                                      .smem)
                assert mg.rows_padded(C, H, 5 if pos else 4) == (
                    not pos or W != C or C // H < 8)
    assert not mg.rows_padded(128, 16, 5)
    for args in ((128, 257, 1), (128, 512, 2), (2048, 96, 24),
                 (300, 64, 32), (5000, 32, 32)):
        with pytest.raises(ValueError, match="K7"):
            mg.plan(*args, pos=pos, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wide_layout_and_stage_copies(dtype):
    """The wide kernel's layout (C = 256: no summary staging, a KV band of
    all 256 columns, a ring of 12 TF32 / 24 bf16 stages, its scratch of
    operand stages) and its stage copies, read back as the kernel reads
    them, K in its natural order (A from shared memory too): stage i of
    the weight copy holds rows r0 .. r0 + 63 and one k-panel from k0 of
    weight_blocks' i-th matrix, every product in 128-column groups; the A
    stages of a scratch buffer (put_a) hold its 64 rows a k-panel, and
    k^T / v^T (put_n) a 64-channel block x a k-panel of the rows."""
    bf16 = dtype == BF16
    lay = mg.rows_layout(256, 2, dtype)
    pk = 64 if bf16 else 32
    assert (lay.kvn, lay.kv_stages, lay.ring, lay.smem) == (
        (256, 16, 24, 224648) if bf16 else (256, 32, 12, 224456))
    ppc = 256 // pk
    assert mg.rows_scratch_bytes(130, 256, 2, dtype) == (
        2 * lay.kv_stages * lay.stage_bytes + 2 * 192 * 256 * 4
        + 2 * (lay.stage_bytes * ppc * (3 * 3 + 4) + 4 * 64 * 128))
    t, d, w1, w2, _ = inputs("point", 1, 1, 3, 256, device="cpu")
    stages = mg.rows_stage_weights(w1, w2, bf16).reshape(-1, 4096)
    seq = mg.weight_blocks(256, pk)
    assert stages.shape[0] == len(seq) == sum(lay.weight_stages)
    s1w, ssw, _ = lay.weight_stages
    # the stage-1 tail: merge by half, then k-panel, then block; fc1[C:] by
    # 128-column group of the hidden columns
    assert seq[:4] == [("merge1", 0, 0), ("merge1", 64, 0),
                       ("merge1", 0, pk), ("merge1", 64, pk)]
    assert seq[ppc * 2] == ("merge1", 128, 0)
    assert seq[ppc * 4:ppc * 4 + 3] == [("fc1b1", 0, 0), ("fc1b1", 64, 0),
                                        ("fc1b1", 0, pk)]
    assert seq[s1w - 1] == ("fc2_1", 192, 512 - pk)
    # [Wk | Wv] once a summary tile, in groups; stage 2's hidden groups
    # take fc1[:C]'s group (over O) before fc1[C:]'s
    assert seq[s1w:s1w + ssw] == mg._groups("kv2", 512, 256, pk)
    h2 = s1w + ssw + 8 * ppc          # after Wq and merge, in halves
    assert [seq[h2 + i * 2 * ppc][0] for i in range(8)] == [
        "fc1a2", "fc1b2"] * 4
    mats = mg._weight_matrices(w1, w2)
    for i in range(0, len(seq), 7):
        name, r0, k0 = seq[i]
        want = mats[name][r0:r0 + 64, k0:k0 + pk]
        want = want.to(BF16).double() if bf16 else want.double()
        assert torch.equal(read_stage(stages[i], bf16, natural=True),
                           want), (i, name)
    # every block of every matrix once
    assert sorted(seq) == sorted(set(seq))
    # the message stages: one band of all C columns a 64-column chunk
    assert mg.message_blocks(256, 16, pk) == [
        (64 * j, b * pk) for j in range(4) for b in range(256 // pk)]
    kvz = t[2]
    ms, _ = mg.message_stages(kvz, 1, bf16)
    kvt = kvz[0, :, :256].t().double()
    for i, (r0, k0) in enumerate(mg.message_blocks(256, 1, pk)):
        got = read_stage(ms[0, i * 4096:(i + 1) * 4096], bf16, natural=True)
        want = kvt[r0:r0 + 64, k0:k0 + pk]
        assert torch.equal(got, want.float().to(dtype).double()), i
    # a scratch buffer's A stages and k^T's, element by element where the
    # kernel's put_a / put_n put them
    g = torch.Generator().manual_seed(1)
    rows = torch.randn(64, 256, generator=g)
    got = _a_stages(rows, bf16)
    for p in range(ppc):
        for r, k in ((0, 0), (9, 3), (63, pk - 1), (17, pk // 2)):
            x = got[p][_offset(r, k, bf16, True)].double()
            if not bf16:
                x = x + got[p][2048 + _offset(r, k, bf16, True)].double()
            assert x == rows[r, p * pk + k].to(dtype).double(), (p, r, k)
        assert torch.equal(read_stage(got[p], bf16, natural=True),
                           rows[:, p * pk:(p + 1) * pk].to(dtype).double())
    kt = _a_stages(rows.t().contiguous(), bf16, nrp=1)   # 256 channels x 64 rows
    for blk in range(4):
        assert torch.equal(
            read_stage(kt[blk], bf16, natural=True)[:, :pk],
            rows[:pk, 64 * blk:64 * blk + 64].t().to(dtype).double())


def _a_stages(x, bf16, nrp=None):
    """A matrix (R rows, K) as the wide kernel's epilogues write it into a
    scratch buffer: stages of 64 rows x one k-panel, natural K order, the
    64-row blocks in turn with nrp k-panels each (all of K by default)
    (put_a; transposed, KT / VT, put_n). Returns (stages, 4,096)."""
    pk = 64 if bf16 else 32
    R, K = x.shape
    nrp = K // pk if nrp is None else nrp
    blocks = [(64 * b, p * pk) for b in range(R // 64) for p in range(nrp)]
    return mg.b_stages(x.float(), blocks, bf16, natural=True).reshape(
        -1, 4096)


def _band(vh, ct, D, pk):
    """The k-panels (p0, np) of the heads' band of the 128-column half vh
    (csrc/match_rows_wg.cuh band)."""
    c0 = 128 * vh
    if c0 >= ct:
        return 0, 0
    klo = c0 // D * D
    khi = min(ct, (min(c0 + 127, ct - 1) // D + 1) * D)
    return klo // pk, -(-khi // pk) - klo // pk


def _unit_on(mi, vh, ct, D):
    """Whether the summary's unit (k block mi, v half vh) meets a head's
    diagonal band (unit_on)."""
    if 64 * mi >= ct or 128 * vh >= ct:
        return False
    ma, mb = 64 * mi // D, min(64 * mi + 63, ct - 1) // D
    va, vb = 128 * vh // D, min(128 * vh + 127, ct - 1) // D
    return ma <= vb and va <= mb


def _wide_seq(N, C, H, ct, bf16):
    """The wide kernel's producer sequence for one pair
    (csrc/match_rows_wg.cuh rows_wide_kernel), in the ring's order: (the
    events the producer has waited for before it, stage), a stage ("w", i)
    the weight copy's i-th, ("kin", x, i) stage i of the stage-1 message
    stages warpgroup x reads, or (buffer, side, i) stage i of a side's
    scratch buffer ("qs", "msg", "hid", "os", "kt", "vt", "kv")."""
    pk = 64 if bf16 else 32
    nh, nb, ppc = C // 128, C // 64, C // pk
    ntiles = -(-N // 64)
    nrp, nrows = ntiles * 64 // pk, -(-N // pk)
    D = ct // H
    s1w, ssw = 10 * nh * ppc, 4 * nh * ppc
    seq, ev, w = [], [0], [0]

    def emit(x):
        seq.append((ev[0], x))

    def event():
        ev[0] += 1

    def prod_w(buf, np, off=0):
        for p in range(np):
            emit((buf, 0, off + p))
            emit((buf, 1, off + p))
            emit(("w", w[0]))
            emit(("w", w[0] + 1))
            w[0] += 2

    def message(kv):
        for vh in range(nh):
            p0, np = _band(vh, ct, D, pk)
            for p in range(p0, p0 + np):
                emit(("qs", 0, p))
                emit(("qs", 1, p))
                for x in range(2):
                    emit(kv(x, 2 * vh * ppc + p))
                    emit(kv(x, (2 * vh + 1) * ppc + p))

    def tail(tile=None):
        event()
        for _ in range(nh):
            prod_w("msg", ppc)
        for g in range(2 * nh):
            if tile is not None:    # stage 2: O fc1[:C] ahead of MID
                prod_w("os", ppc, tile * ppc)
            if g == 0:
                event()
            prod_w("qs", ppc)
        event()
        for _ in range(nh):
            prod_w("hid", 2 * ppc)

    for tile in range(ntiles):
        w[0] = 0
        event()
        message(lambda x, i: ("kin", x, i))
        tail()
    event()
    for tile in range(ntiles):
        w[0] = s1w
        for _ in range(2 * nh):
            prod_w("os", ppc, tile * ppc)
    event()
    for mi in range(nb):
        for vh in range(nh):
            if not _unit_on(mi, vh, ct, D):
                continue
            for r in range(nrows):
                emit(("kt", 0, mi * nrp + r))
                emit(("kt", 1, mi * nrp + r))
                for x in range(2):
                    emit(("vt", x, 2 * vh * nrp + r))
                    emit(("vt", x, (2 * vh + 1) * nrp + r))
    event()
    for tile in range(ntiles):
        w[0] = s1w + ssw
        for _ in range(nh):
            prod_w("os", ppc, tile * ppc)
        event()
        message(lambda x, i: ("kv", 1 - x, i))
        tail(tile)
    return seq


class _WideRing:
    """The producer's sequence of a pair, taken in order by the consumers'
    model; a scratch stage is read as its buffer stood at the event the
    producer waited for before issuing it, and only once the consumers
    have reached that event."""

    def __init__(self, seq, weights, kin, bf16):
        self.seq, self.i, self.bf16 = seq, 0, bf16
        self.weights, self.kin = weights, kin
        self.scr = {}           # (buffer, side) -> stages as last written
        self.snaps = []         # the buffers at each event

    def write(self, buf, side, stages):
        self.scr[buf, side] = stages

    def arrive(self):
        self.snaps.append(dict(self.scr))

    def take(self):
        ev, (kind, *ref) = self.seq[self.i]
        self.i += 1
        if kind == "w":
            return read_stage(self.weights[ref[0]], self.bf16, natural=True)
        x, i = ref
        if kind == "kin":
            st = self.kin[x][i * 4096:(i + 1) * 4096]
        else:
            assert len(self.snaps) >= ev > 0, (kind, ev, len(self.snaps))
            st = self.snaps[ev - 1][kind, x][i]
        return read_stage(st, self.bf16, natural=True)


def _chan(stats, y, ct, c0):
    """Chan's merge of the 128-column group y (2, 64, 128) from c0 into the
    running (count, mean, sum of squared deviations) of each row."""
    n, mean, m2 = stats
    nb = max(0, min(128, ct - c0))
    if nb == 0:
        return stats
    yb = y[..., :nb]
    mb = yb.mean(-1, keepdim=True)
    qb = ((yb - mb) ** 2).sum(-1, keepdim=True)
    nn = n + nb
    delta = mb - mean
    return nn, mean + delta * nb / nn, m2 + qb + delta * delta * n * nb / nn


def _wide_model(t, d, w1, w2, H, ti, dj, bf16, ct):
    """One pair through the wide kernel's walk (csrc/match_rows_wg.cuh
    rows_wide_kernel) in float64, sides and weights at W = 256 (ct true
    channels): every product takes both operands from the producer's
    sequence (_wide_seq: the weight copy, stage 1's messages from
    message_stages, the scratch rows each epilogue writes as A stages),
    a scratch stage read as its buffer stood at the event the producer
    waited for; the outputs in 128-column groups, the message over its
    heads' band only, LayerNorm from Chan-merged statistics of the halves,
    the summary's k and v once a tile and KV over the diagonal units only.
    Returns the pooled (2W,)."""
    C, N = t[0].shape[2], t[0].shape[1]
    pk = 64 if bf16 else 32
    nb, nh, ppc = C // 64, C // 128, C // pk
    D = ct // H
    heads = torch.clamp(torch.arange(C) // D, max=H - 1)
    W = mg.rows_stage_weights(w1, w2, bf16).reshape(-1, 4096)
    side = [tuple(x[i].double() for x in s) for s, i in ((t, ti), (d, dj))]
    kin = [mg.message_stages(s[2][i:i + 1], 1, bf16) for s, i in
           ((d, dj), (t, ti))]          # warpgroup 0 reads the det side's
    ring = _WideRing(_wide_seq(N, C, H, ct, bf16), W,
                     [kin[0][0][0], kin[1][0][0]], bf16)
    ntiles = -(-N // 64)
    Np = ntiles * 64
    lane = (torch.arange(C) < ct).double()

    def rows(x, r0, n=64):
        out = torch.zeros(n, x.shape[-1], dtype=torch.float64)
        m = max(0, min(n, N - r0))
        out[:m] = x[r0:r0 + m]
        return out

    def write(buf, x):          # both sides' rows (2, R, K) as A stages
        for s in range(2):
            ring.write(buf, s, _a_stages(x[s], bf16))

    def product(npan, shared=True, out=None):
        """out (2, 64, 128) += own A @ own B over npan panels."""
        out = torch.zeros(2, 64, 128, dtype=torch.float64) \
            if out is None else out
        for _ in range(npan):
            a = [ring.take(), ring.take()]
            b = ([ring.take(), ring.take()] * 2 if shared
                 else [ring.take() for _ in range(4)])
            for s in range(2):
                out[s] += a[s] @ torch.cat(b[2 * s:2 * s + 2]).t()
        return out

    def den_of(q, ks, rnd_den):
        prod = q * ks[:, None, :]
        prod = prod.to(BF16).double() if rnd_den and bf16 else prod
        return torch.stack([(prod * (heads == h)).sum(-1)
                            for h in range(H)], -1)

    def halves_ln(npan, s, b):
        stats = (0, torch.zeros(2, 64, 1, dtype=torch.float64),
                 torch.zeros(2, 64, 1, dtype=torch.float64))
        out = []
        for hf in range(nh):
            y = product(npan)
            stats = _chan(stats, y, ct, 128 * hf)
            out.append(y)
        n, mean, m2 = stats
        assert n == ct
        y = torch.cat(out, -1)
        return (y - mean) / torch.sqrt(m2 / n + 1e-5) * s.double() + \
            b.double()

    def tail(den, init, w):
        msg = torch.zeros(2, 64, C, dtype=torch.float64)
        for vh in range(nh):
            mz = product(_band(vh, ct, D, pk)[1], shared=False)
            cols = heads[128 * vh:128 * vh + 128]
            msg[..., 128 * vh:128 * vh + 128] = mz / (den[:, :, cols] + 1e-6)
        write("msg", msg)
        ring.arrive()
        m = halves_ln(ppc, w["ln1_scale"], w["ln1_bias"])
        write("qs", m)
        ring.arrive()
        hid = torch.cat([torch.relu(init(g) + product(ppc))
                         for g in range(2 * nh)], -1)
        write("hid", hid)
        ring.arrive()
        return halves_ln(2 * ppc, w["ln2_scale"], w["ln2_bias"])

    O = torch.zeros(2, Np, C, dtype=torch.float64)
    ks_in = torch.stack([kin[0][1][0].double(), kin[1][1][0].double()])
    for tile in range(ntiles):
        r0 = tile * 64
        q = torch.stack([rows(s[1], r0) for s in side])
        den = den_of(q, ks_in, False)
        write("qs", q)
        ring.arrive()
        y = tail(den, lambda g: torch.stack(
            [rows(s[3], r0)[:, 128 * g:128 * g + 128] for s in side]), w1)
        O[:, r0:r0 + 64] = torch.stack([rows(s[0], r0) for s in side]) + y
    for s in range(2):
        ring.write("os", s, _a_stages(O[s], bf16, nrp=ppc))
    ring.arrive()
    # the summary: k and v once a tile, transposed; KV over the units on the
    # heads' diagonal
    kt = torch.zeros(2, C, Np, dtype=torch.float64)
    vt = torch.zeros(2, C, Np, dtype=torch.float64)
    for tile in range(ntiles):
        r0 = tile * 64
        e = torch.cat([product(ppc) for _ in range(2 * nh)], -1)
        valid = (r0 + torch.arange(64) < N).double()[None, :, None]
        k = torch.where(e[..., :C] > 0, e[..., :C] + 1, torch.exp(e[..., :C]))
        v = e[..., C:]
        if len(side[0]) == 5:   # the point head's position term
            v = v + torch.stack([rows(s[4], r0) for s in side])
        kt[:, :, r0:r0 + 64] = (k * lane * valid).transpose(1, 2)
        vt[:, :, r0:r0 + 64] = (v * valid).transpose(1, 2)
    nrp = Np // pk
    for s in range(2):
        ring.write("kt", s, _a_stages(kt[s], bf16, nrp=nrp))
        ring.write("vt", s, _a_stages(vt[s], bf16, nrp=nrp))
    ring.arrive()
    ksum = kt.sum(-1)
    kv = torch.zeros(2, C, C, dtype=torch.float64)
    for mi in range(nb):
        for vh in range(nh):
            if _unit_on(mi, vh, ct, D):
                kv[:, 64 * mi:64 * mi + 64, 128 * vh:128 * vh + 128] = \
                    product(-(-N // pk), shared=False)
    kv *= (heads[:, None] == heads[None, :])
    # put_n writes the message stages of KV^T's band that the units cover;
    # the others hold what an earlier pair left (here NaN)
    put = [(2 * vh + e) * ppc + p for mi in range(nb) for vh in range(nh)
           if _unit_on(mi, vh, ct, D) for e in range(2)
           for p in range(64 * mi // pk, (64 * mi + 64) // pk)]
    stale = torch.ones(nb * ppc, dtype=torch.bool)
    stale[put] = False
    for s in range(2):
        st = _a_stages(kv[s].t().contiguous(), bf16)
        st[stale] = float("nan")
        ring.write("kv", s, st)
    ring.arrive()
    out_max = torch.full((C,), -float("inf"), dtype=torch.float64)
    out_sum = torch.zeros(C, dtype=torch.float64)
    ks = torch.stack([ksum[1], ksum[0]])
    for tile in range(ntiles):
        r0 = tile * 64
        e = torch.cat([product(ppc) for _ in range(nh)], -1)
        q = torch.where(e > 0, e + 1, torch.exp(e)) * lane
        den = den_of(q, ks, True)
        write("qs", q)
        ring.arrive()
        # a hidden group starts from its a = O fc1[:C]
        y = tail(den, lambda g: product(ppc), w2)
        o = O[:, r0:r0 + 64]
        res = (o + y)[:, :max(0, min(64, N - r0))]
        out_max = torch.maximum(out_max, res.amax((0, 1)))
        out_sum += res.sum((0, 1))
    assert ring.i == len(ring.seq) and len(ring.snaps) == ring.seq[-1][0]
    return torch.cat([out_max, out_sum / (2 * N)])


@pytest.mark.parametrize("head,C,H,N", [("point", 256, 2, 70),
                                        ("point", 200, 5, 20),
                                        ("image", 256, 16, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_a_model_of_the_wide_walk_meets_the_plain_chain(head, C, H, N,
                                                        dtype):
    """The wide kernel's stage copies, taken in the producer's order by the
    products of its walk (a ragged second m-tile; 200 channels padded to
    256 in heads of 40 that cross the 128-column halves; the image head in
    16 heads), give the plain version's pooled features at the true width:
    the orders of weight_blocks, message_blocks and the summary's units
    agree with the chain."""
    bf16 = dtype == BF16
    t, d, w1, w2, _ = inputs(head, 2, 2, N, C, H, device="cpu",
                             dtype=dtype)
    Wd = mg.kernel_width(C, mg.ROWS)
    assert Wd == 256
    pw1, pw2 = mg.pad_weights(w1, w2, Wd)
    got = mg.unpad_pooled(_wide_model(
        mg.pad_side(t, Wd), mg.pad_side(d, Wd), pw1, pw2, H, 1, 0, bf16, C),
        C)
    want = mg.match_pooled_reference(t, d, w1, w2, H, torch.tensor([1]),
                                     torch.tensor([0]))[0].double()
    assert (got - want).abs().max() <= WALK_TOL[dtype] * max(
        1.0, want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_a_model_of_the_walk_at_16_heads_meets_the_plain_chain(dtype):
    """C = 128 in 16 heads of 8 channels (heads16) on the exact
    instantiation: the chain's walk (normalisers of 16 heads, a head per
    n-tile, a 64-column KV band) gives the plain version's pooled
    features."""
    bf16 = dtype == BF16
    t, d, w1, w2, H = inputs("point", 2, 2, 40, 128, 16, device="cpu",
                             dtype=dtype)
    assert not mg.rows_padded(128, H, 5)
    assert mg.rows_layout(128, H, dtype).kvn == 64
    got = _kernel_model(t, d, w1, w2, H, 1, 0, bf16)
    want = mg.match_pooled_reference(t, d, w1, w2, H, torch.tensor([1]),
                                     torch.tensor([0]))[0].double()
    assert (got - want).abs().max() <= WALK_TOL[dtype] * max(
        1.0, want.abs().max())


# ---- the widths against JAX --------------------------------------------------------

def _point_models(seed: int, **kw):
    """(jax model, jax variables, torch model) of the tiny flagship with
    `kw` (conv_out, mul) and `heads` heads in both cross stages."""
    heads = kw.pop("heads", 2)
    cfg = tcfg.point_transformer_point_cat(**dict(TINY, **kw))
    jcfg = jmodels.point_transformer_point_cat(**dict(TINY, **kw))
    for c in (cfg, jcfg):
        c["cross_stage1"]["nhead"] = c["cross_stage2"]["nhead"] = heads
    tmodel = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tmodel))
    return jax_build(jcfg), jvars, tmodel


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,kw", [
    ("conv_out256", dict(conv_out=256)),
    ("heads16", dict(conv_out=128, heads=16)),
    ("mul16", dict(conv_out=128, mul=16))])
def test_point_width_matches_jax(name, kw):
    """Embeddings, the scorer's grid and a pair list of the tiny flagship
    at the configs/widths.py entry's widths (conv_out 256 in two
    128-channel heads; 16 heads of 8 channels; SA widths 512 / 1024 / 2048
    at mul 16), the port against JAX."""
    jmodel, jvars, tmodel = _point_models(len(name), **kw)
    a, b = crops(70, 3), crops(71, 4)
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(a))
        xd, hd = tmodel.embed(torch.from_numpy(b))
    assert ht.shape == (3, 32, kw["conv_out"])
    _, jh = jmodel.apply(jvars, jnp.asarray(a), train=False, method="embed")
    _close(ht.numpy(), jh, MODEL_TOL, MODEL_TOL)
    args = (ht, xt, hd, xd)
    jargs = tuple(jnp.asarray(x.numpy()) for x in args)
    scorer = PairScorer(tmodel)
    assert scorer.fused
    ti, di = torch.tensor([0, 1, 2, 2, 0]), torch.tensor([3, 0, 1, 2, 2])
    with torch.no_grad():
        grid = scorer.cost_matrix(*args)
        pairs = scorer._pairs(*args, ti, di)
    _close(grid.numpy(), JaxScorer(jmodel, jvars).cost_matrix(*jargs),
           GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), jmg.xla_pair_logits(
        jmodel, jvars, *jargs, jnp.asarray(ti.numpy()),
        jnp.asarray(di.numpy())), GRID_RTOL, GRID_ATOL)


def test_image_width_256_matches_jax():
    """Tokens, the scorer's grid and a pair list of the tiny image model at
    downsample_dim 256 (two 128-channel heads, image256), the port against
    JAX."""
    cfg = _image_cfg(256)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(256))
    jmodel, jvars = jax_build(copy.deepcopy(cfg)), jax_variables_of(
        tmodel, "deit-test")
    ia, ib = images(72, 3), images(73, 4)
    with torch.no_grad():
        ht = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ia)))
        hd = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ib)))
    assert ht.shape[-1] == 256
    jt = jmodel.apply(jvars, jmodel.apply(jvars, jnp.asarray(ia), train=False,
                                          method="embed"),
                      train=False, method="downsample_tokens")
    _close(ht.numpy(), jt, MODEL_TOL, MODEL_TOL)
    scorer = PairScorer(tmodel, image_mode=True)
    assert scorer.fused
    ti, di = torch.tensor([0, 1, 2, 2, 0]), torch.tensor([3, 0, 1, 2, 2])
    with torch.no_grad():
        grid = scorer.cost_matrix(ht, None, hd, None)
        pairs = scorer._image_pairs(ht, hd, ti, di)
    jt, jd = jnp.asarray(ht.numpy()), jnp.asarray(hd.numpy())
    _close(grid.numpy(), JaxScorer(jmodel, jvars, image_mode=True).cost_matrix(
        jt, None, jd, None), GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), jmg.xla_image_pair_logits(
        jmodel, jvars, jt, jd, jnp.asarray(ti.numpy()),
        jnp.asarray(di.numpy())), GRID_RTOL, GRID_ATOL)
