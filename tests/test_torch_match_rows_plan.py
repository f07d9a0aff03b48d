"""The match chain's wgmma rows tier on the CPU (csrc/match_rows_wg.cuh):
kernels/match_grid.plan at every rows-tier shape of the registered leaves,
its refusals, the layout's bytes, and the stage copies the wrapper hands the
kernel, read back byte for byte the way the kernel reads them. A model of
the kernel's walk (the producer's stage order, each consumer product taking
its stages, the summary written as the other side's message stages) runs
the chain from those bytes and meets the plain version; the card holds the
kernel itself to the plain version (tests/test_torch_kernels_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.configs.experiments import (  # noqa: E402
    EXPERIMENTS, get_experiment)
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_match import inputs  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = torch.bfloat16
LEAVES = {
    "1.5M": "pts_point-transformer-1.5M_point-cat_nus_det_4x256_500e",
    "7M": "pts_point-transformer-7M_point-cat_nus_det_4x256_500e",
    "2048pts": "pts_point-transformer_point-cat_waymo_det_4x256_400e_2048pts",
}
# shared bytes of the layout (csrc/match_rows_wg.cuh Cfg::BYTES): 1,024 to
# align, the ring, two warpgroups' staging, sum k, partials, normalisers and
# the mbarriers; the normalisers hold 8 heads for a launch of at most 8
# (BYTES), 16 past them and in the padded layout (PADDED)
BYTES = {(64, torch.float32): 224920, (128, torch.float32): 231512,
         (64, BF16): 175880, (128, BF16): 215304}
PADDED = {(64, torch.float32): 229016, (128, torch.float32): 219208,
          (64, BF16): 179976, (128, BF16): 219400}


def _match_shape(name: str):
    """(N, C, heads) the leaf's match head scores: its crop size (the
    serving subsample, or the ablation's points), its width and heads."""
    m = get_experiment(name)["model"]
    C = m["cross_stage1"]["d_model"]
    N = 2048 if name.endswith("2048pts") else 128
    return N, C, m["cross_stage1"]["nhead"]


def test_the_leaves_are_registered():
    assert set(LEAVES.values()) <= set(EXPERIMENTS)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_plan_sends_the_leaves_to_the_wgmma_tier(leaf, dtype):
    """The 1.5M / 7M leaves (C = 128) and the 2048-point ablation (C = 64,
    past the cluster layouts' 224 / 208 rows) take the wgmma rows tier at
    both dtypes, with the layout's exact bytes, within a block's shared
    memory; so do a ragged m-tile, the most heads and, at C = 128, a row."""
    N, C, H = _match_shape(LEAVES[leaf])
    for n, h in ((N, H), (1 if C == 128 else N - 1, H), (N + 1, H), (N, 8)):
        assert mg.plan(n, C, h, dtype=dtype) == mg.Plan(mg.ROWS,
                                                         BYTES[C, dtype])
    assert BYTES[C, dtype] <= mg.MAX_SMEM
    assert (mg.rows_bytes_bf16 if dtype == BF16 else mg.rows_bytes)(C) == \
        BYTES[C, dtype]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_layout_geometry(dtype):
    """Stages of 64 output columns x one 128-byte k-panel (bf16: 64
    columns, 8 KB; TF32: 32 columns, hi and lo, 16 KB); a side's KV band is
    64 columns an m-tile of channels, all 128 where a head has 128
    channels; the ring as deep as shared memory allows, at most 16."""
    bf16 = dtype == BF16
    for C, H in ((64, 1), (64, 8), (128, 2), (128, 8), (128, 1)):
        lay = mg.rows_layout(C, H, dtype)
        assert (lay.pk, lay.stage_bytes) == ((64, 8192) if bf16
                                             else (32, 16384))
        assert lay.kvn == (128 if C // H == 128 else 64)
        assert lay.kv_stages == C // 64 * lay.kvn // lay.pk
        assert lay.smem == BYTES[C, dtype]
        assert 4 <= lay.ring <= mg.RING_MAX
        assert len(mg.weight_blocks(C, lay.pk)) == sum(lay.weight_stages)
    assert [mg.rows_layout(C, 2, dtype).ring for C in (64, 128)] == (
        [16, 16] if bf16 else [9, 5])
    # 16 heads' normalisers: the float32 C = 128 ring's fifth stage
    assert [mg.rows_layout(C, 16, dtype).smem for C in (64, 128)] == [
        PADDED[64, dtype], PADDED[128, dtype]]
    assert mg.rows_layout(128, 16, dtype).ring == (16 if bf16 else 4)
    # scratch: both KV message sets, a = O fc1[:C] of an m-tile a side, O
    assert mg.rows_scratch_bytes(65, 64, 2, dtype) == (
        2 * mg.rows_layout(64, 2, dtype).kv_stages
        * mg.rows_layout(64, 2, dtype).stage_bytes + 2 * 64 * 128 * 4
        + 2 * 128 * 64 * 4)


def test_c16_keeps_the_first_rows_kernel_and_the_refusals():
    """C = 16 past the cluster layout goes to the first rows kernel (tier
    rows_mma) at its layout; other widths and the image head go to the
    padded cluster or rows tier; what no tier takes still raises."""
    for dtype, nbytes in ((torch.float32, 42048), (BF16, 45120)):
        assert mg.plan(4000, 16, 2, dtype=dtype) == mg.Plan(mg.ROWS_MMA,
                                                            nbytes)
    for args, want in (((10, 12, 2), (mg.CLUSTER, mg.cluster_bytes(10, 16))),
                       ((128, 32, 2), (mg.CLUSTER, mg.cluster_bytes(128, 64))),
                       ((128, 128, 2, False), (mg.ROWS, PADDED[128, torch.float32])),
                       ((260, 64, 2, False), (mg.ROWS, PADDED[64, torch.float32])),
                       ((4000, 12, 3), (mg.ROWS, PADDED[64, torch.float32]))):
        assert mg.plan(*args) == mg.Plan(*want)
    for args, kw, match in (((128, 1025, 1), {}, "K7"),
                            ((128, 2048, 2), dict(dtype=BF16), "K7"),
                            ((2048, 96, 24), {}, "K7"),
                            ((225, 64, 32), {}, "at most 16 heads"),
                            ((128, 128, 32), dict(dtype=BF16),
                             "at most 16 heads"),
                            ((0, 64, 2), {}, "N >= 1"),
                            ((128, 64, 3), {}, "dividing")):
        with pytest.raises(ValueError, match=match):
            mg.plan(*args, **kw)


def test_cpu_launches_count_no_tier():
    """On the CPU the wrappers run the plain version at a rows-tier shape:
    no launch is counted, in all or by tier."""
    t, d, w1, w2, H = inputs("point", 2, 2, 5, 128, device="cpu")
    fns = (mg.fused_match_grid, mg.fused_match_pairs)
    before = [(f.launches, f.bf16_launches, dict(f.tier_launches))
              for f in fns]
    mg.fused_match_grid(t, d, w1, w2, H)
    mg.fused_match_pairs(t, d, w1, w2, H, torch.tensor([1, 0]),
                         torch.tensor([0, 0]))
    assert [(f.launches, f.bf16_launches, f.tier_launches)
            for f in fns] == before
    assert set(before[0][2]) == {"cluster", "rows", "rows_mma",
                                 "cluster_bf16", "rows_bf16",
                                 "rows_mma_bf16"}


# ---- the kernel's reads of a stage ----

def _k_pos(r: int) -> int:
    """k position of real column r (0 .. 7) of an 8-group in a TF32 stage
    (csrc/tf32_mma.cuh k_pos)."""
    return (r >> 1) + 4 * (r & 1)


def _offset(row: int, pos: int, bf16: bool, natural: bool = False) -> int:
    """Index of element (row, real k pos) in a stage's values: byte row *
    128 + (its 16-byte unit ^ (row % 8)) * 16 + its place in the unit (the
    128-byte swizzle of csrc/bf16_mma.cuh sw128), at TF32 after the k
    position of tf32::k_pos (not where `natural`: the wide kernel's
    operands, put_n / put_a); over the element size."""
    if bf16:
        return (row * 128 + (((pos >> 3) ^ (row & 7)) << 4)
                + (pos & 7) * 2) // 2
    p = pos if natural else (pos & ~7) | _k_pos(pos & 7)
    return (row * 128 + (((p >> 2) ^ (row & 7)) << 4) + (p & 3) * 4) // 4


_OFFSETS = {(b, n): torch.tensor([[_offset(r, k, b, n)
                                   for k in range(64 if b else 32)]
                                  for r in range(64)])
            for b in (False, True) for n in (False, True)}


def read_stage(stage: torch.Tensor, bf16: bool,
               natural: bool = False) -> torch.Tensor:
    """A stage (4,096 values) as the kernel reads it: (64 rows, k-panel) in
    real K order, float64; at TF32 hi + lo (lo 2,048 values on)."""
    flat = stage.double()
    idx = _OFFSETS[bf16, natural]
    return flat[idx] if bf16 else flat[idx] + flat[2048 + idx]


@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_weight_stages_lie_as_the_kernel_reads_them(C, dtype):
    """rows_stage_weights: stage i of the copy holds rows r0 .. r0 + 63
    and one k-panel from k0 of weight_blocks' i-th matrix (in (out, in)
    layout), as the kernel reads it; bf16 values are the weights rounded;
    TF32 hi + lo is the weight exactly and hi has TF32's low 13 mantissa
    bits clear."""
    bf16 = dtype == BF16
    t, d, w1, w2, H = inputs("point", 1, 1, 3, C, device="cpu")
    flat = mg.rows_stage_weights(w1, w2, bf16)
    assert flat.dtype == (BF16 if bf16 else torch.float32)
    stages = flat.reshape(-1, 4096)
    seq = mg.weight_blocks(C, 64 if bf16 else 32)
    assert stages.shape[0] == len(seq)
    mats = mg._weight_matrices(w1, w2)
    pk = 64 if bf16 else 32
    for i in range(0, len(seq), max(1, len(seq) // 9)):
        name, r0, k0 = seq[i]
        want = mats[name][r0:r0 + 64, k0:k0 + pk]
        want = want.to(BF16).double() if bf16 else want.double()
        assert torch.equal(read_stage(stages[i], bf16), want), (i, name)
    if not bf16:
        hi = stages[:, :2048].contiguous()
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        lo = stages[:, 2048:]
        # hi + lo rebuilds every weight value exactly (in float32)
        got = sorted((hi + lo).reshape(-1).tolist())
        want = sorted(torch.cat([
            mats[n][r:r + 64, k:k + 32].reshape(-1) for n, r, k in seq
        ]).tolist())
        assert got == want


@pytest.mark.parametrize("C,H", [(64, 2), (128, 1), (128, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_message_stages_hold_the_heads_band(C, H, dtype):
    """message_stages: for each 64-column chunk j of the message, KV^T's
    rows of the chunk over its heads' band (64 columns from 64 j, or all
    128 at 128-channel heads), k-panel by k-panel; sum k is Z's
    diagonal."""
    bf16 = dtype == BF16
    t, d, w1, w2, _ = inputs("point", 2, 1, 6, C, H, device="cpu",
                             dtype=dtype)
    kvz = t[2]
    stages, ks = mg.message_stages(kvz, H, bf16)
    pk = 64 if bf16 else 32
    blocks = mg.message_blocks(C, H, pk)
    assert stages.shape == (2, len(blocks) * 4096)
    assert len(blocks) == mg.rows_layout(C, H, dtype).kv_stages
    for o in range(2):
        kvt = kvz[o, :, :C].t().double()
        for i, (r0, k0) in enumerate(blocks):
            got = read_stage(stages[o, i * 4096:(i + 1) * 4096], bf16)
            assert torch.equal(got, kvt[r0:r0 + 64, k0:k0 + pk]), (o, i)
        assert torch.equal(ks[o], torch.diagonal(kvz[o, :, C:]).float())
    # the band holds every non-zero of KV: heads never cross it
    kvn = mg.rows_layout(C, H, dtype).kvn
    band = torch.zeros(C, C, dtype=torch.bool)
    for j in range(C // 64):
        lo = 64 * j if kvn == 64 else 0
        band[64 * j:64 * j + 64, lo:lo + kvn] = True
    assert not (kvz[:, :, :C].transpose(1, 2).float() * ~band).any()


# ---- a model of the kernel's walk over one pair ----

class _Ring:
    """The producer's stage sequence of a pair, read in order."""

    def __init__(self, seq, bf16):
        self.seq, self.i, self.bf16 = seq, 0, bf16

    def take(self):
        s = self.seq[self.i]
        self.i += 1
        return read_stage(s, self.bf16)


def _kv_stages(kv: torch.Tensor, kvn: int, bf16: bool) -> torch.Tensor:
    """KV (C, C, float64, masked) as the kernel's put_b writes it into a
    side's message stages: element (m, n) at stage (n // 64, band panel of
    m), row n % 64, real k (m - the band's start) within the panel; TF32 hi
    and lo."""
    C = kv.shape[0]
    pk = 64 if bf16 else 32
    bp = kvn // pk
    buf = torch.zeros(C // 64 * bp * 4096,
                      dtype=BF16 if bf16 else torch.float32)
    idx, val = [], []
    for n in range(C):
        klo = 64 * (n // 64) if kvn == 64 else 0
        for kk in range(kvn):
            stage = (n // 64) * bp + kk // pk
            idx.append(stage * 4096 + _offset(n % 64, kk % pk, bf16))
            val.append(float(kv[klo + kk, n]))
    idx, x = torch.tensor(idx), torch.tensor(val, dtype=torch.float32)
    if bf16:
        buf[idx] = x.to(BF16)
    else:
        hi = (x.view(torch.int32) & -8192).view(torch.float32)
        buf[idx], buf[idx + 2048] = hi, x - hi
    return buf


def _kernel_model(t, d, w1, w2, H, ti, dj, bf16):
    """One pair through the kernel's walk (csrc/match_rows_wg.cuh) in
    float64: every product takes its stages from the producer's sequence
    (weights from rows_stage_weights, stage 1's messages from
    message_stages, stage 2's from the summary written with put_b), both
    sides (warpgroups) in step. Returns the pooled (2C,)."""
    C, N = t[0].shape[2], t[0].shape[1]
    dt = BF16 if bf16 else torch.float32
    lay = mg.rows_layout(C, H, dt)
    pk, kvn, sr = lay.pk, lay.kvn, 64 if bf16 else 32
    nb, ch2, ppc, pph, bp = C // 64, 2 * C // 64, C // pk, 64 // pk, kvn // pk
    D = C // H
    rnd = ((lambda x: x.to(BF16).double()) if bf16 else (lambda x: x))
    W = mg.rows_stage_weights(w1, w2, bf16).reshape(-1, 4096)
    s1w, ssw, _ = lay.weight_stages
    side = [tuple(x[i].double() for x in s) for s, i in ((t, ti), (d, dj))]
    kin = [mg.message_stages(s[2][i:i + 1], H, bf16) for s, i in
           ((d, dj), (t, ti))]          # warpgroup 0 reads the det side's
    ntiles = -(-N // 64)
    Np = ntiles * 64

    def rows(x, r0, n=64):
        out = torch.zeros(n, x.shape[-1], dtype=torch.float64)
        m = max(0, min(n, N - r0))
        out[:m] = x[r0:r0 + m]
        return out

    def ln(x, s, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * s.double() + b.double()

    def tail_seq(w, kv):
        seq = []
        for j in range(nb):
            for x in range(2):
                seq += [kv[x][(j * bp + b) * 4096:(j * bp + b + 1) * 4096]
                        for b in range(bp)]
            seq += [W[w + i] for i in range(pph * nb)]
            w += pph * nb
        seq += [W[w + i] for i in range(ch2 * (ppc + pph * nb))]
        return seq

    def product(ring, A, nbk, npan, p0=0, out=None):
        """out[:, 64 rb ..] += A's panels p0 .. @ stages (rb inner)."""
        out = torch.zeros(2, 64, 64 * nbk, dtype=torch.float64) \
            if out is None else out
        for p in range(npan):
            for rb in range(nbk):
                B = ring.take()
                a = rnd(A[:, :, (p0 + p) * pk:(p0 + p + 1) * pk])
                out[:, :, 64 * rb:64 * rb + 64] += a @ B.t()
        return out

    def message(ring, q, ks, round_den):
        prod = q * ks[:, None, :]
        prod = rnd(prod) if round_den else prod
        den = torch.stack([prod[..., h * D:(h + 1) * D].sum(-1)
                           for h in range(H)], -1)      # (2, 64, H)
        mgv = torch.zeros(2, 64, C, dtype=torch.float64)
        for j in range(nb):
            klo = 64 * j if kvn == 64 else 0
            mz = torch.zeros(2, 64, 64, dtype=torch.float64)
            for x in range(2):
                for b in range(bp):
                    B = ring.take()
                    p = klo // pk + b
                    mz[x] += rnd(q[x, :, p * pk:(p + 1) * pk]) @ B.t()
            heads = (64 * j + torch.arange(64)) // D
            msg = mz / (den[:, :, heads] + 1e-6)
            product(ring, msg, nb, pph, out=mgv)
        return mgv

    def ffn(ring, m, init):
        y = torch.zeros(2, 64, C, dtype=torch.float64)
        for h in range(ch2):
            hid = init(h) + product(ring, m, 1, ppc)
            product(ring, torch.relu(hid), nb, pph, out=y)
        return y

    O = torch.zeros(2, Np, C, dtype=torch.float64)
    ksides = [kin[0][1][0].double(), kin[1][1][0].double()]
    for tile in range(ntiles):
        r0 = tile * 64
        ring = _Ring(tail_seq(0, [kin[0][0][0], kin[1][0][0]]), bf16)
        q = torch.stack([rows(s[1], r0) for s in side])
        m = ln(message(ring, q, torch.stack(ksides), False),
               w1["ln1_scale"], w1["ln1_bias"])
        y = ln(ffn(ring, m, lambda h: torch.stack(
            [rows(s[3], r0)[:, 64 * h:64 * h + 64] for s in side])),
            w1["ln2_scale"], w1["ln2_bias"])
        O[:, r0:r0 + 64] = torch.stack([rows(s[0], r0) for s in side]) + y
        assert ring.i == len(ring.seq)
    # the summary of each side, written as the other side's message stages
    kv = torch.zeros(2, C, C, dtype=torch.float64)
    ksum = torch.zeros(2, C, dtype=torch.float64)
    for st in range(-(-N // sr)):
        r0 = st * sr
        o = torch.zeros(2, 64, C, dtype=torch.float64)
        o[:, :sr] = O[:, r0:r0 + sr]
        ring = _Ring([W[s1w + i] for i in range(ssw)], bf16)
        e = torch.zeros(2, 64, 2 * C, dtype=torch.float64)
        for i in range(ch2):
            e[:, :, 64 * i:64 * i + 64] = product(ring, o, 1, ppc)
        k = torch.where(e[..., :C] > 0, e[..., :C] + 1, torch.exp(e[..., :C]))
        v = e[..., C:] + torch.stack([rows(s[4], r0) for s in side])
        valid = (torch.arange(64) < sr) & (r0 + torch.arange(64) < N)
        k, v = k * valid[None, :, None], v * valid[None, :, None]
        ksum += k.sum(1)
        kv += rnd(k).transpose(1, 2) @ rnd(v)
    heads = torch.arange(C) // D
    kv *= (heads[:, None] == heads[None, :])
    kout = [_kv_stages(kv[s], kvn, bf16) for s in range(2)]
    out_max = torch.full((C,), -float("inf"), dtype=torch.float64)
    out_sum = torch.zeros(C, dtype=torch.float64)
    for tile in range(ntiles):
        r0 = tile * 64
        w = s1w + ssw
        ring = _Ring([W[w + i] for i in range(ppc * nb + ch2 * ppc)]
                     + tail_seq(w + ppc * nb + ch2 * ppc, [kout[1], kout[0]]),
                     bf16)
        o = O[:, r0:r0 + 64]
        q = product(ring, o, nb, ppc)
        q = torch.where(q > 0, q + 1, torch.exp(q))
        a2 = torch.cat([product(ring, o, 1, ppc) for _ in range(ch2)], -1)
        ks = torch.stack([ksum[1], ksum[0]])
        m = ln(message(ring, q, ks, True), w2["ln1_scale"], w2["ln1_bias"])
        y = ln(ffn(ring, m, lambda h: a2[..., 64 * h:64 * h + 64]),
               w2["ln2_scale"], w2["ln2_bias"])
        assert ring.i == len(ring.seq)
        res = (o + y)[:, :max(0, min(64, N - r0))]
        out_max = torch.maximum(out_max, res.amax((0, 1)))
        out_sum += res.sum((0, 1))
    return torch.cat([out_max, out_sum / (2 * N)])


@pytest.mark.parametrize("N,C,H", [(70, 64, 2), (20, 128, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_a_model_of_the_kernel_walk_meets_the_plain_chain(N, C, H, dtype):
    """The stage copies, taken in the producer's order by the products of
    the kernel's walk (a ragged second m-tile at C = 64; 128-channel heads
    at C = 128), give the plain version's pooled features: the orders of
    weight_blocks, message_blocks and the kernel's own summary stages agree
    with the chain."""
    bf16 = dtype == BF16
    t, d, w1, w2, _ = inputs("point", 2, 2, N, C, H, device="cpu",
                             dtype=dtype)
    got = _kernel_model(t, d, w1, w2, H, 1, 0, bf16)
    want = mg.match_pooled_reference(t, d, w1, w2, H, torch.tensor([1]),
                                     torch.tensor([0]))[0].double()
    tol = 1e-2 if bf16 else 1e-5
    assert (got - want).abs().max() <= tol * max(1.0, want.abs().max())
