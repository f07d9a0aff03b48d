"""The shape gaps of the TPU kernels on the CPU (ROADMAP.md K5, K6b): the
SA stage at any width up to 2048 channels and the match chain up to 256
channels and 16 heads, the bounds of the layouts they brought in. (The
wider shapes they serve since, to 8192 SA channels and 1024 match channels
in 32 heads (K7), are tests/test_torch_k7_widths.py's, which reuses the
walk models here; the refusals below moved to those bounds.)

Here:
  - the SA wrapper's padded layout (kernels/sa_stage.pad_args: zeros in
    the lanes past C) through the plain version equals the unpadded plain
    version bit for bit; a model of the wide layout's walk
    (csrc/sa_wide_wg.cuh: centre groups with repeated slots, the
    producer's stage order with its events, conv2's A stages from the h1
    scratch, h2 read from the scratch as it stood at the event the
    producer waited for, the max folded over a group's m-tiles) meets the
    plain version at both dtypes; its stage copies read back byte for
    byte; the plans of both SA kernels at the new widths;
  - kernels/match_grid.plan at every new width, head count, head and
    dtype, and its refusal past the bound naming ROADMAP.md's K7;
  - the rows tier's wide kernel (C = 256, csrc/match_rows_wg.cuh
    rows_wide_kernel): its stage copies (weights, and the A stages of its
    scratch rows) read back byte for byte, and a model of its walk (the
    producer's stage order, each scratch stage read as it stood at the
    event the producer waited for, every output in 128-column groups, the
    message over its heads' band, LayerNorm from Chan-merged halves, the
    summary's k and v once a tile and KV over the diagonal units only,
    written as the other side's message stages, sum k and the pooling
    through a warpgroup's staging) against the plain chain,
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
    _OFFSETS, _kernel_model, _offset, read_stage)
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


def _a_unit(r, u, bf16):
    """Index of 16-byte unit u (4 float32 / 8 bf16 values) of row r of the
    wide layout's A stages in the stage's values, as the kernel's gather
    stores it (csrc/sa_wide_wg.cuh gather: unit u ^ (r % 8) of its row)."""
    per = 8 if bf16 else 4
    return (u >> 3, r * 8 * per + ((u & 7) ^ (r & 7)) * per)


def _write_a_units(stages, rows, bf16):
    """A matrix (64 rows, C) into a buffer's A stages by 16-byte units, the
    gather's stores."""
    per = 8 if bf16 else 4
    for u in range(rows.shape[1] // per):
        for r in range(64):
            p, i = _a_unit(r, u, bf16)
            stages[p][i:i + per] = rows[r, u * per:(u + 1) * per]


def _write_a_pairs(stages, rows, c0, bf16):
    """Columns c0 .. c0 + 127 (or to the width's end) of (64, C) rows into a
    buffer's A stages value by value where the kernel's put_pair puts them
    (_offset: the same 128-byte swizzle, K natural)."""
    pk = 64 if bf16 else 32
    for c in range(c0, min(c0 + 128, rows.shape[1])):
        for r in range(64):
            stages[c // pk][_offset(r, c % pk, bf16, True)] = rows[r, c]


def _read_a(stage, bf16):
    """An A stage (64 rows x one k-panel) as the products read it: float64
    in real K order (one value a place: the A stages hold no lo)."""
    return stage.double()[_OFFSETS[bf16, True]]


def _sa_wide_seq(C, K, BS, blocks, b, bf16):
    """The wide layout's producer sequence for block b
    (csrc/sa_wide_wg.cuh sa_wide_kernel), in the ring's order: (the
    events the producer has waited for before it, slot), a slot ("a",
    conv, p) the A stages of k-panel p of the two warpgroups' h1 (conv 0)
    or h2 (conv 1), or ("w", conv, i, n) n B stages of conv 2 + conv's
    stage copy from its i-th: per output chunk j of 128 columns (64 at the
    end) and k-panel p, the A slot then the chunk's blocks."""
    pk = 64 if bf16 else 32
    ppc, nch, q = C // pk, -(-C // 128), -(-K // 16)
    supers = -(-(-(-BS // 4)) // 2)
    seq, ev = [], 0
    for _ in range(b, supers, blocks):
        for _mt in range(q):
            for conv in range(2):
                ev += 1
                for j in range(nch):
                    nb = min(2, C // 64 - 2 * j)
                    for p in range(ppc):
                        seq.append((ev, ("a", conv, p)))
                        first = 2 * j * ppc + p * nb
                        seq += ([(ev, ("w", conv, first, nb))] if bf16 else
                                [(ev, ("w", conv, first + x, 1))
                                 for x in range(nb)])
    return seq


class _SaRing:
    """The producer's sequence of a block, taken in order by the
    consumers' model (both warpgroups take every slot); an A slot holds
    each warpgroup's stage as its buffer stood at the event the producer
    waited for before issuing it, and only once the consumers have reached
    that event."""

    def __init__(self, seq, copies, bf16):
        self.seq, self.i, self.bf16, self.copies = seq, 0, bf16, copies
        self.scr = {}
        self.snaps = []

    def arrive(self):
        self.snaps.append({k: [x.clone() for x in v]
                           for k, v in self.scr.items()})

    def take(self, want):
        ev, item = self.seq[self.i]
        self.i += 1
        assert item[:2] == want[:2] and (item[0] == "w" or item == want), (
            item, want)
        assert len(self.snaps) >= ev > 0, (item, ev, len(self.snaps))
        if item[0] == "a":
            _, conv, p = item
            return [_read_a(self.snaps[ev - 1][conv, wg][p], self.bf16)
                    for wg in range(2)]
        _, conv, first, n = item
        st = self.copies[conv].reshape(-1, 4096)
        return [read_stage(st[first + x], self.bf16, natural=True)
                for x in range(n)]


def _sa_wide_model(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3, blocks):
    """The wide layout's walk in float64 (bf16: h1 and h2 rounded to bf16 as
    the kernel stores them): each block's two warpgroups take a pair of
    4-centre groups at a time, ceil(K / 16) m-tiles of 64 rows each (warp
    w the 16 neighbour slots of centre w, slots past K repeating neighbour
    K - 1, centres past B S the last centre, not stored); per m-tile the
    gather into the h1 scratch [event], conv2 chunk by chunk over the
    ring's slots into the h2 scratch [event], conv3 chunk by chunk, each
    lane's columns folded into its centre's running max."""
    bf16 = A.dtype == BF16
    B, N, C = A.shape
    S, K = idx.shape[1:]
    BS, pk = B * S, (64 if bf16 else 32)
    q, ppc, nch = -(-K // 16), C // pk, -(-C // 128)
    supers = -(-(-(-BS // 4)) // 2)
    copies = sa.wide_stage_weights(w2, w3, bf16)
    vec = [v.double() for v in (s1, t1, s2, t2, s3, t3)]
    rnd = ((lambda x: x.to(BF16).double()) if bf16 else (lambda x: x))
    out = torch.full((BS, C), float("nan"), dtype=torch.float64)
    Af, Ctf = A.reshape(-1, C).double(), Ct.reshape(-1, C).double()
    src = idx.reshape(BS, K).long() + (torch.arange(BS) // S * N)[:, None]
    for b in range(blocks):
        ring = _SaRing(_sa_wide_seq(C, K, BS, blocks, b, bf16), copies, bf16)
        for sup in range(b, supers, blocks):
            own = [torch.arange(4) + 4 * (2 * sup + wg) for wg in range(2)]
            ctr = [o.clamp(max=BS - 1) for o in own]
            runmax = [torch.zeros(4, C, dtype=torch.float64) for _ in range(2)]
            for mt in range(q):
                slots = (torch.arange(16) + 16 * mt).clamp(max=K - 1)
                for wg in range(2):
                    rows = src[ctr[wg][:, None], slots[None, :]].reshape(-1)
                    h1 = torch.relu((Af[rows] + Ctf[ctr[wg]].repeat_interleave(
                        16, 0)) * vec[0] + vec[1])
                    ring.scr[0, wg] = [torch.zeros(4096 if bf16 else 2048)
                                       for _ in range(ppc)]
                    _write_a_units(ring.scr[0, wg], rnd(h1).float(), bf16)
                ring.arrive()
                for conv in range(2):
                    if conv:
                        ring.arrive()
                    for wg in range(2):
                        ring.scr.setdefault((1, wg), [
                            torch.zeros(4096 if bf16 else 2048)
                            for _ in range(ppc)])
                    for j in range(nch):
                        nb = min(2, C // 64 - 2 * j)
                        acc = [torch.zeros(64, 64 * nb, dtype=torch.float64)
                               for _ in range(2)]
                        for p in range(ppc):
                            a = ring.take(("a", conv, p))
                            wb = []
                            for _ in range(1 if bf16 else nb):
                                wb += ring.take(("w", conv))
                            wt = torch.cat(wb, 0)     # (64 nb out, pk in)
                            for wg in range(2):
                                acc[wg] += a[wg] @ wt.t()
                        cols = slice(128 * j, 128 * j + 64 * nb)
                        for wg in range(2):
                            y = acc[wg] * vec[2 + 2 * conv][cols] + vec[
                                3 + 2 * conv][cols]
                            if conv == 0:
                                full = torch.zeros(64, C, dtype=torch.float64)
                                full[:, cols] = rnd(torch.relu(y))
                                _write_a_pairs(ring.scr[1, wg], full.float(),
                                               128 * j, bf16)
                            else:
                                m = y.reshape(4, 16, -1).amax(1).clamp(min=0)
                                runmax[wg][:, cols] = torch.maximum(
                                    runmax[wg][:, cols], m)
            for wg in range(2):
                keep = own[wg] < BS
                out[own[wg][keep]] = runmax[wg][keep]
        assert ring.i == len(ring.seq)
    assert not out.isnan().any()
    return out.reshape(B, S, C)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("B,S,K", [(2, 8, 48), (3, 5, 20), (2, 7, 5),
                                   (1, 3, 16), (3, 3, 1), (2, 5, 37)])
def test_sa_wide_walk_model_meets_the_plain_version(B, S, K, dtype):
    """A model of the wide layout's walk at a stand-in width of 192 (a
    128-column chunk and a 64-column one; the kernel's widths are 928 ..
    2048): the producer's sequence of slots and events, every A slot read
    from the scratch as it stood at its event, every B stage from the
    wrapper's stage copy at the producer's offset, one block walking
    several pairs of groups where there are several (K = 48 and 37: three
    m-tiles a group; K = 1 and 5: one, slots past K repeated; B S of 16,
    15, 14, 3, 9, 10 centres: groups and pairs of groups part empty), meets
    the plain version (float32: WALK_TOL; bf16 with h1 and h2 rounded as
    the kernel stores them: BF16 WALK_TOL)."""
    C = 192
    args = _sa_args(B, 30, S, K, C, seed=K, dtype=dtype)
    want = sa.sa_convmax_reference(*args).double()
    supers = -(-(-(-B * S // 4)) // 2)
    got = _sa_wide_model(*args, blocks=max(1, supers - 1))
    assert (got - want).abs().max() <= WALK_TOL[dtype] * max(
        1.0, want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_sa_wide_stage_copies_lie_as_the_kernel_reads_them(dtype):
    """wide_stage_weights: B stage (j, p, b) of the copy, at (2 j PPC + p
    nb + b) stages (nb the chunk's 64-row blocks, 1 at the end of a width
    64 past a multiple of 128), holds output rows 64 (2 j + b) .. and input
    columns p PK .. of w (in, out), K natural, bf16 rounded or TF32 hi +
    lo exactly, hi with TF32's low 13 mantissa bits clear; made once per
    weight tensor. The gather's 16-byte units and put_pair's values land
    where the products read them."""
    bf16 = dtype == BF16
    C = 320                                # chunks of 128, 128, 64
    pk = 64 if bf16 else 32
    g = torch.Generator().manual_seed(3)
    w2, w3 = (torch.randn(C, C, generator=g) for _ in range(2))
    copies = sa.wide_stage_weights(w2, w3, bf16)
    assert copies[0] is sa.wide_stage_weights(w2, w3, bf16)[0]
    for w, flat in zip((w2, w3), copies):
        assert flat.dtype == (BF16 if bf16 else torch.float32)
        st = flat.reshape(-1, 4096)
        assert st.shape[0] == (C // 64) * (C // pk)
        for j in range(3):
            nb = min(2, C // 64 - 2 * j)
            for p in range(0, C // pk, 2):
                for b in range(nb):
                    got = read_stage(st[2 * j * (C // pk) + p * nb + b], bf16,
                                     natural=True)
                    want = w[p * pk:(p + 1) * pk,
                             64 * (2 * j + b):64 * (2 * j + b + 1)].t()
                    want = want.to(BF16) if bf16 else want
                    assert torch.equal(got, want.double()), (j, p, b)
        if not bf16:
            assert not (st[:, :2048].contiguous().view(torch.int32)
                        & 0x1FFF).any()
    rows = torch.randn(64, C, generator=g).to(dtype).float()
    units = [torch.zeros(4096 if bf16 else 2048) for _ in range(C // pk)]
    pairs = [torch.zeros(4096 if bf16 else 2048) for _ in range(C // pk)]
    _write_a_units(units, rows, bf16)
    for c0 in range(0, C, 128):
        _write_a_pairs(pairs, rows, c0, bf16)
    for p in range(C // pk):
        assert torch.equal(units[p], pairs[p])
        assert torch.equal(_read_a(units[p], bf16),
                           rows[:, p * pk:(p + 1) * pk].double())


def test_sa_plans_past_1024_channels():
    """The float32 kernel: two buffers of M rows below 928 channels, the
    wide layout from there (where the buffers hold one 16-row m-tile) to
    2048; the bf16 kernel: the wgmma tier at 1024, the wide layout past it.
    The wide layout: 12 warps, 128 rows a weight stage, a ring of 14 16 KB
    slots in 230,632 shared bytes at every width, a scratch a block of two
    warpgroups' h1 and h2 stages and running maxima at the next multiple
    of 64. Past 8192 both raise naming ROADMAP.md's K7 (the bound was 2048
    before; tests/test_torch_k7_widths.py takes the widths between)."""
    for W in range(32, 2049, 32):
        how = sa.plan_f32(W, 48)
        assert how.smem <= sa.MAX_SMEM
        assert how.layout == (sa.WIDE if W >= 928 else sa.TWO_BUFFERS)
        if W == 896:
            assert how.tile_rows == 32
        if W > 1024:
            assert sa.plan_bf16(W, 48).tier == sa.WIDE
    for W, f32_scratch, bf16_scratch in ((1024, 1081344, 557056),
                                         (1056, 1148928, 591872),
                                         (1536, 1622016, 835584),
                                         (2048, 2162688, 1114112)):
        for bf16, scratch in ((False, f32_scratch), (True, bf16_scratch)):
            Wd = -(-W // 64) * 64
            pk = 64 if bf16 else 32
            assert scratch == 2 * (2 * Wd // pk * 8192 + 16 * Wd)
            assert sa.wide_scratch_bytes(W, bf16) == scratch
        assert sa.plan_f32(W, 48) == sa.SaF32Plan(
            sa.WIDE, 12, 16, 128, 230632, True, 14, f32_scratch)
        if W > 1024:
            assert sa.plan_bf16(W, 48) == sa.SaPlan(
                sa.WIDE, 128, 2, 1, 14, 230632, True, bf16_scratch)
    assert sa.plan_bf16(1024, 48).tier == sa.WGMMA
    assert sa.plan_f32(896, 48).layout == sa.TWO_BUFFERS
    assert sa.WIDE_SMEM == 1024 + 14 * 16384 + 8 * 29 <= sa.MAX_SMEM
    assert [sa.kernel_width(C) for C in (1, 16, 33, 1025, 2047, 2048)] == [
        32, 32, 64, 1056, 2048, 2048]
    assert [sa.wide_width(W) for W in (928, 1024, 1056, 2016)] == [
        960, 1024, 1088, 2048]
    # the width the wrapper pads to once: the wide layout's at 64
    assert [sa.run_width(C, False) for C in (896, 900, 928, 1040, 2000)] == [
        896, 928 + 32, 960, 1088, 2048]
    assert [sa.run_width(C, True) for C in (928, 992, 1024, 1025, 1040)] == [
        928, 992, 1024, 1088, 1088]
    for C in (8193, 16384):
        with pytest.raises(ValueError, match="K7"):
            sa.kernel_width(C)
    with pytest.raises(NotImplementedError, match="K7"):
        sa.plan_bf16(8224, 48)


# ---- the match chain to 256 channels and 16 heads (K6b) ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("pos", [True, False])
def test_plan_takes_every_width_to_256_channels_and_16_heads(pos, dtype):
    """A tier for every C from 129 to 256 in up to 16 heads (the rows tier's
    wide kernel, at 256, its bytes those of one head's layout), and for 9
    to 16 heads at every width they divide (the rows tier wherever the
    cluster tier's layout does not fit); the padded entry points where
    rows_padded says. Past 1024 channels (256 before), or 16 heads where
    the rows tier is needed at 128 channels or fewer, ValueError naming
    ROADMAP.md's K7."""
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
    for args in ((128, 1025, 1), (128, 2048, 2), (2048, 96, 24),
                 (300, 64, 32), (5000, 32, 32)):
        with pytest.raises(ValueError, match="K7"):
            mg.plan(*args, pos=pos, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wide_layout_and_stage_copies(dtype):
    """The wide kernel's layout (C = 256: no summary staging, a KV band of
    all 256 columns, a ring of 12 TF32 / 24 bf16 stages in the shared bytes
    of every width, its scratch of operand stages and its pooling row) and its stage copies, read back as the kernel reads
    them, K in its natural order (A from shared memory too): stage i of
    the weight copy holds rows r0 .. r0 + 63 and one k-panel from k0 of
    weight_blocks' i-th matrix, every product in 128-column groups; the A
    stages of a scratch buffer (put_a) hold its 64 rows a k-panel, and
    k^T / v^T (put_n) a 64-channel block x a k-panel of the rows."""
    bf16 = dtype == BF16
    lay = mg.rows_layout(256, 2, dtype)
    pk = 64 if bf16 else 32
    assert (lay.kvn, lay.kv_stages, lay.ring, lay.smem) == (
        (256, 16, 24, 230792) if bf16 else (256, 32, 12, 230600))
    ppc = 256 // pk
    assert mg.rows_scratch_bytes(130, 256, 2, dtype) == (
        2 * lay.kv_stages * lay.stage_bytes + 2 * 192 * 256 * 4
        + 2 * (lay.stage_bytes * ppc * (3 * 3 + 4) + 4 * 64 * 128
               + 4 * 2 * 256))
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


def _staged(x, op, start=0.0):
    """The wide kernel's reduction of a side's rows x (2, R, C) into one
    row a side (warpgroup): for each 64-row m-tile, each warp's 16 rows
    reduced, the 4 warps' results combined in warp order through the
    warpgroup's staging, then into the side's running row, tile by tile
    (sum k, and the pooling's max and sum)."""
    run = torch.full((2, x.shape[-1]), start, dtype=x.dtype)
    for r0 in range(0, x.shape[1], 64):
        warps = [x[:, r0 + 16 * w:r0 + 16 * w + 16] for w in range(4)]
        warps = [w for w in warps if w.shape[1]]
        if op is torch.add:
            red = [w.sum(1) for w in warps]
        else:
            red = [w.amax(1) for w in warps]
        tile = red[0]
        for w in red[1:]:
            tile = op(tile, w)
        run = op(run, tile)
    return run


def _wide_model(t, d, w1, w2, H, ti, dj, bf16, ct):
    """One pair through the wide kernel's walk (csrc/match_rows_wg.cuh
    rows_wide_kernel) in float64, sides and weights at the kernel's width
    W, a multiple of 128 (ct true channels): every product takes both
    operands from the producer's sequence (_wide_seq: the weight copy,
    stage 1's messages from message_stages, the scratch rows each epilogue
    writes as A stages), a scratch stage read as its buffer stood at the
    event the producer waited for; the outputs in 128-column groups, the
    message over its heads' band only, LayerNorm from Chan-merged
    statistics of the groups, the summary's k and v once a tile and KV
    over the diagonal units only; sum k and the pooling through each
    warpgroup's staging (_staged). Returns the pooled (2W,)."""
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
    ksum = _staged(kt.transpose(1, 2), torch.add)
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
    pooled = []
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
        pooled.append(O[:, r0:r0 + 64] + y)
    assert ring.i == len(ring.seq) and len(ring.snaps) == ring.seq[-1][0]
    rows_ = torch.cat(pooled, 1)[:, :N]
    pmax = _staged(rows_, torch.maximum, -float("inf"))
    psum = _staged(rows_, torch.add)
    return torch.cat([torch.maximum(pmax[0], pmax[1]),
                      (psum[0] + psum[1]) / (2 * N)])


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
    point_width_against_jax(name, kw)


def point_width_against_jax(name, kw):
    """test_point_width_matches_jax at one width (also
    tests/test_torch_k7_widths.py's)."""
    jmodel, jvars, tmodel = _point_models(len(name), **dict(kw))
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
    image_width_against_jax(256)


def image_width_against_jax(dim: int):
    """test_image_width_256_matches_jax at downsample_dim `dim` (also
    tests/test_torch_k7_widths.py's)."""
    cfg = _image_cfg(dim)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(dim))
    jmodel, jvars = jax_build(copy.deepcopy(cfg)), jax_variables_of(
        tmodel, "deit-test")
    ia, ib = images(72, 3), images(73, 4)
    with torch.no_grad():
        ht = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ia)))
        hd = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ib)))
    assert ht.shape[-1] == dim
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
