"""Fused per-pair match chain: track x detection grid or an explicit pair list.

Port of point_cloud_reid_tpu/ops/pallas/match_grid.py (fused_match_grid,
fused_match_pairs, pallas_grid_logits, pallas_pair_logits, grid_factors,
stage_weights). Everything that depends on one object is computed once per
object in plain torch (`grid_factors`); the per-pair chain -- stage-1 linear
attention finish in both directions, merge + LN + FFN + LN, stage-2 full
cross linear attention in both directions, point-cat max+avg pooling -- is
one CUDA kernel that serves both index modes. The match head on the pooled
features stays plain torch, as in JAX.

`plan(N, C, H)` picks the float32 kernel's tier: CLUSTER
(csrc/match_grid.cu, a two-block cluster a pair with the weights and a
side's rows in shared memory: C up to 64, as many rows as fit, 224 at C =
64) wherever it fits, else ROWS (csrc/match_rows.cu instantiating
csrc/match_rows_wg.cuh: C up to 1024, up to 16 heads (32 past 128 channels),
any N; two warpgroups on wgmma, a side each, the weights streamed through a
ring of shared-memory stages from a stage copy made once,
`rows_stage_weights`, the stage-1 outputs in a device scratch; past 128
channels its wide kernel, which keeps the chain's C-wide rows in the scratch
as operand stages it streams through the ring beside the weights, and
computes every C-wide output in 128-column groups) or, for the point head at
C = 16 in up to 8 heads, ROWS_MMA (the first rows kernel, kept in the same
file: a block a pair at a time on mma.sync).

The kernels' tiles are instantiated at the widths W = 16 and 64 (cluster)
and 64, 128 and every multiple of 128 from 256 to 1024 (rows: the wide
kernel takes its width at run time). A head of another width C <= 1024 (a
model built with --set model.backbone.conv_out=96, say) runs at the smallest
W of its tier that holds it, in the padded layout (`pad_side`,
`pad_weights`): the true channels first, zeros in lanes C .. W - 1 of every
factor, weight and LayerNorm vector, the FFN's hidden 2C of 2W the same way;
the heads keep their C / H channels each, contiguous. The kernels' padded
instantiations (the `_pad` entry points, given the true C) mask what zeros
alone would get wrong: elu+1 of a padded stage-2 q or k lane (1, not 0) and
the LayerNorm statistics (over the true C). The pooled output is sliced back
to [max | avg] of the true C. `padded_reference` is the CPU model of that
layout. The rows tier's padded entry points also serve heads of fewer than 8
channels, the image head and every width of the wide kernel (`rows_padded`).
Past 1024 channels, or past 16 heads where the rows tier is needed at 128
channels or fewer, or past 32 on the wide kernel, the plan raises
(ROADMAP.md K7).

The image head (CrossLinAttn; image_grid_factors, image_grid_logits,
image_pair_logits, ports of image_grid_factors, pallas_image_grid_logits and
pallas_image_pair_logits) is the same chain without any position term: a
side is four tensors (h, q, kvz, a1), not five, and the kernel's second
instantiation scores it over the true token count S. The TPU kernel's
8-row token padding and its in-kernel mask (_pad_tokens, n_true) are
Mosaic workarounds and are dropped.

Sharded scoring (sharded_grid_logits, sharded_pair_logits,
sharded_image_grid_logits, sharded_image_pair_logits; ports of the JAX
shard_map wrappers): the detections (grid) or the pair list (pairs) go in
contiguous shards, one a mesh entry (parallel.make_mesh), and each shard's
factors, kernel and match head run on its entry's device with that
device's copy of the weights (utils.cache.model_on); the tracks, or both
sides of a pair list, are copied to every entry. No collective: pairs are
independent. The TPU wrappers' tiling contracts (nd a multiple of 8 mesh
entries, P of 16, det blocks) are dropped: the kernels take any count, so
any count shards, a count below the mesh size over fewer entries.

On CPU tensors the wrappers run `match_pooled_reference`, the plain version
of the kernel; on CUDA tensors they launch the kernel; any other device
raises. The 1/N value pre-scale and the xN message rescale of
linear_attention cancel and are both dropped, as in the TPU kernel.

Under a bf16 model the factors are computed in float32 from the bf16
embeddings and cast to bf16, as JAX's grid_factors does; the weights stay
float32 and every product of the chain multiplies bf16-rounded operands with
float32 accumulation, the pooled output in bf16 (the TPU kernel's _make_dot).
On CUDA `plan(..., dtype=torch.bfloat16)` picks the bf16 tiers:
CLUSTER (csrc/match_grid_bf16.cu: a persistent two-block cluster on wgmma
with the weights resident in shared memory, C up to 64, up to 208 rows at
C = 64), else ROWS (csrc/match_rows_bf16.cu: the same wgmma structure as
the float32 rows tier, one bf16 pass a product, C up to 1024 at any N) or
ROWS_MMA for the point head at C = 16; a bf16 model never runs a float32
kernel. The wrapper hands the kernels bf16 copies of the weights made once
(utils/cache.py): the rows tier's in its stage layout. bf16 launches count
in each wrapper's `bf16_launches`, float32 ones in `launches`; both count
by tier in `tier_launches` (keys "cluster", "rows", "rows_mma", each also
with "_bf16"), and those in the padded layout also in `padded_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cache import derived, model_on
from . import _lib
from .sa_stage import BF16, fused_sa_convmax, rounded_mm

EPS = 1e-6
LN_EPS = 1e-5

_WEIGHT_ORDER = (("w1", "merge"), ("w1", "ln1_scale"), ("w1", "ln1_bias"),
                 ("w1", "fc1"), ("w1", "fc2"), ("w1", "ln2_scale"),
                 ("w1", "ln2_bias"), ("w2", "q"), ("w2", "kv"),
                 ("w2", "merge"), ("w2", "ln1_scale"), ("w2", "ln1_bias"),
                 ("w2", "fc1"), ("w2", "fc2"), ("w2", "ln2_scale"),
                 ("w2", "ln2_bias"))

# (h, q, kvz, a1, pv) for the point head, (h, q, kvz, a1) for the image head
Side = Tuple[torch.Tensor, ...]
_PARTS = ("h", "q", "kvz", "a1", "pv")


def _elu1(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def _linear(m, x: torch.Tensor) -> torch.Tensor:
    """A Linear in its weights' dtype whatever the model's compute dtype:
    the factors' products are float32, as JAX's grid_factors multiplies
    the raw float32 weights."""
    return F.linear(x, m.weight, m.bias)


def _pos_mlp(seq, xyz: torch.Tensor) -> torch.Tensor:
    return _linear(seq[2], torch.relu(_linear(seq[0], xyz)))


def _stage1_factors(stage1, h: torch.Tensor, v_in: torch.Tensor, nhead: int):
    """Per-object stage-1 factors (q, kvz, a1) in float32 (h promoted);
    the point and the image head differ only in what feeds v_proj:
    h + pos_mlp(xyz) or plain h."""
    n, N, C = h.shape
    D = C // nhead
    wide = torch.promote_types(h.dtype, torch.float32)
    h, v_in = h.to(wide), v_in.to(wide)
    q = _elu1(_linear(stage1.q_proj, h))
    k = _elu1(_linear(stage1.k_proj, h))
    v = _linear(stage1.v_proj, v_in)
    kv = torch.einsum("bnc,bnd->bcd", k, v)
    heads = torch.arange(C, device=h.device) // D
    gmask = (heads[:, None] == heads[None, :]).to(h.dtype)
    kv = kv * gmask
    zmat = k.sum(dim=1)[:, :, None] * gmask[None]
    kvz = torch.cat([kv, zmat], dim=-1)
    a1 = h @ stage1.mlp[0].weight[:, :C].t()
    return q, kvz, a1


def grid_factors(stage1, stage2, h: torch.Tensor, xyz: torch.Tensor,
                 nhead: int) -> Side:
    """Per-object factors of the pair chain from the two cross stages,
    computed in float32 and returned in h's dtype (float32, or bf16 under
    a bf16 model, as in JAX).

    Returns (h, q, kvz, a1, pv), all contiguous:
        q:   (n, N, C)  elu+1 stage-1 queries;
        kvz: (n, C, 2C) [KV | Z]: KV = k^T v, block-diagonal per head (no
             1/N), Z = diag(ksum) @ head mask;
        a1:  (n, N, 2C) h @ stage1.fc1[:C], the search half of the stage-1
             FFN's first layer;
        pv:  (n, N, C)  stage-2 pos-MLP(xyz) @ v_proj.
    """
    q, kvz, a1 = _stage1_factors(stage1, h, h + _pos_mlp(stage1.pos_mlp, xyz),
                                 nhead)
    pv = _linear(stage2.v_proj, _pos_mlp(stage2.pos_mlp, xyz))
    return tuple(x.to(h.dtype).contiguous() for x in (h, q, kvz, a1, pv))


def image_grid_factors(stage1, h: torch.Tensor, nhead: int) -> Side:
    """Per-object factors of the image head (CrossLinAttn has no pos-MLP):
    (h, q, kvz, a1) as in grid_factors, over the true token count."""
    q, kvz, a1 = _stage1_factors(stage1, h, h, nhead)
    return tuple(x.to(h.dtype).contiguous() for x in (h, q, kvz, a1))


def stage_weights(stage1, stage2) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """The kernel's weight dicts, matrices in (in, out) layout, float32
    (the weights' own dtype); made once per set of weights."""
    params = tuple(stage1.parameters()) + tuple(stage2.parameters())
    return derived(params, "match_stage_weights",
                   lambda: _stage_weights(stage1, stage2))


def _stage_weights(stage1, stage2):
    def common(s):
        return dict(merge=s.merge.weight.t(),
                    ln1_scale=s.norm1.weight, ln1_bias=s.norm1.bias,
                    fc1=s.mlp[0].weight.t(), fc2=s.mlp[2].weight.t(),
                    ln2_scale=s.norm2.weight, ln2_bias=s.norm2.bias)
    w1, w2 = common(stage1), common(stage2)
    w2.update(q=stage2.q_proj.weight.t(),
              kv=torch.cat([stage2.k_proj.weight.t(),
                            stage2.v_proj.weight.t()], dim=1))
    w1 = {k: v.detach().contiguous() for k, v in w1.items()}
    w2 = {k: v.detach().contiguous() for k, v in w2.items()}
    return w1, w2


# ---- plain version of the kernel ---------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every matrix product of the plain chain: the products the kernel runs
    on the tensor cores, in one place."""
    return a @ b


def _lane_mask(W: int, ct: int, device) -> torch.Tensor:
    """1.0 on the true lanes 0 .. ct - 1 of a W-wide padded row, else 0."""
    return (torch.arange(W, device=device) < ct).float()


def _layer_norm(x, scale, bias, ct=None):
    """LayerNorm over the last dim; with `ct` (the padded layout, lanes ct
    .. W - 1 holding zeros) its statistics over the true ct lanes, as the
    kernels' padded instantiations take them: the mean from the sum of
    every lane, the variance from the true lanes' deviations."""
    if ct is None or ct == x.shape[-1]:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPS)
    mu = x.sum(dim=-1, keepdim=True) / ct
    dev = (x - mu) * _lane_mask(x.shape[-1], ct, x.device)
    var = (dev * dev).sum(dim=-1, keepdim=True) / ct
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _ffn(search, msg, a, w, mm=None, ct=None):
    """merge -> LN -> FFN([search || msg]) -> LN -> residual, with the FFN's
    first layer split into search and message halves; `mm` the products
    (_mm by default), `ct` the true width of a padded layout."""
    mm = mm or _mm
    C = search.shape[-1]
    m = _layer_norm(mm(msg, w["merge"]), w["ln1_scale"], w["ln1_bias"], ct)
    if a is None:
        a = mm(search, w["fc1"][:C])
    h = torch.relu(a + mm(m, w["fc1"][C:]))
    return search + _layer_norm(mm(h, w["fc2"]), w["ln2_scale"],
                                w["ln2_bias"], ct)


def _split_norm(mz, C):
    return mz[..., :C] / (mz[..., C:] + EPS)


def _stage2(search, template, pv, w, nhead, mm=None, ct=None):
    """Stage 2's message; in a padded layout (`ct` true lanes of C) the
    heads are the true ct / nhead channels each from lane 0 and elu+1 of a
    padded q or k lane is masked to 0."""
    mm = mm or _mm
    C = search.shape[-1]
    D = (ct or C) // nhead
    q = _elu1(mm(search, w["q"]))
    tkv = mm(template, w["kv"])
    k = _elu1(tkv[..., :C])
    if ct is not None and ct < C:
        lane = _lane_mask(C, ct, search.device)
        q, k = q * lane, k * lane
    v = tkv[..., C:] if pv is None else tkv[..., C:] + pv
    heads = torch.arange(C, device=search.device) // D
    gmask = (heads[:, None] == heads[None, :]).to(search.dtype)
    kv = mm(k.transpose(1, 2), v) * gmask
    ks = k.sum(dim=1, keepdim=True)
    return mm(q, kv) / (mm(q * ks, gmask) + EPS)


def _pooled_pairs(t: Side, d: Side, w1, w2, nhead: int,
                  ct: Optional[int] = None) -> torch.Tensor:
    """The chain in the factors' dtype: float32, or bf16 factors whose
    chain runs in float32 with bf16 operands to every product and a bf16
    result (the TPU kernel under a bf16 model). `ct`: the true width of
    sides and weights in the padded layout (pad_side, pad_weights)."""
    dt = t[0].dtype
    mm = _mm
    if dt == BF16:
        t, d = tuple(x.float() for x in t), tuple(x.float() for x in d)
        mm = functools.partial(rounded_mm, dtype=dt)
    ht, qt, kvzt, at = t[:4]
    hd, qd, kvzd, ad = d[:4]
    pvt = t[4] if len(t) == 5 else None      # image head: no position term
    pvd = d[4] if len(d) == 5 else None
    C = ht.shape[-1]
    o1a = _ffn(ht, _split_norm(mm(qt, kvzd), C), at, w1, mm, ct)
    o2a = _ffn(hd, _split_norm(mm(qd, kvzt), C), ad, w1, mm, ct)
    o1b = _ffn(o1a, _stage2(o1a, o2a, pvd, w2, nhead, mm, ct), None, w2, mm,
               ct)
    o2b = _ffn(o2a, _stage2(o2a, o1a, pvt, w2, nhead, mm, ct), None, w2, mm,
               ct)
    mx = torch.maximum(o1b.amax(dim=1), o2b.amax(dim=1))
    av = 0.5 * (o1b.mean(dim=1) + o2b.mean(dim=1))
    return torch.cat([mx, av], dim=-1).to(dt)


def check_pair_range(t_idx: torch.Tensor, d_idx: torch.Tensor, nt: int,
                     nd: int) -> None:
    """Raise unless t_idx and d_idx are (P,) lists in [0, nt) and [0, nd).
    The kernel and its plain version both check, so they fail alike; on
    CUDA tensors this reads four scalars back to the host."""
    if t_idx.dim() != 1 or t_idx.shape != d_idx.shape:
        raise ValueError(f"pair indices: want two (P,) lists, got "
                         f"{tuple(t_idx.shape)} and {tuple(d_idx.shape)}")
    if t_idx.numel() == 0:
        return
    t_lo, t_hi, d_lo, d_hi = torch.stack(
        [t_idx.min().long(), t_idx.max().long(), d_idx.min().long(),
         d_idx.max().long()]).tolist()
    if t_lo < 0 or t_hi >= nt or d_lo < 0 or d_hi >= nd:
        raise IndexError(f"pair indices out of range: tracks [{t_lo}, {t_hi}]"
                         f" of {nt}, detections [{d_lo}, {d_hi}] of {nd}")


# pairs per step of the plain version, which bounds its temporaries
_PLAIN_CHUNK = 2048


def match_pooled_reference(t: Side, d: Side, w1, w2, nhead: int,
                           t_idx: torch.Tensor, d_idx: torch.Tensor,
                           ct: Optional[int] = None) -> torch.Tensor:
    """Plain version of the kernel: (P, 2C) pooled [max || avg] features of
    the pairs (t_idx[p], d_idx[p]), computed in chunks of pairs. Sides of
    five tensors are the point head's, sides of four the image head's.
    `ct`: sides and weights in the padded layout of true width ct."""
    if len(t) != len(d) or len(t) not in (4, 5):
        raise ValueError(f"sides of {len(t)} and {len(d)} tensors: want 5 "
                         "(point head) or 4 (image head) on both")
    check_pair_range(t_idx, d_idx, t[0].shape[0], d[0].shape[0])
    outs = []
    for lo in range(0, t_idx.shape[0], _PLAIN_CHUNK):
        ti = t_idx[lo:lo + _PLAIN_CHUNK].long()
        di = d_idx[lo:lo + _PLAIN_CHUNK].long()
        outs.append(_pooled_pairs(tuple(x[ti] for x in t),
                                  tuple(x[di] for x in d), w1, w2, nhead, ct))
    return torch.cat(outs, dim=0)


# ---- the padded layout -------------------------------------------------------

def _lanes(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zeros appended to its last dim up to `width`."""
    return F.pad(x, (0, width - x.shape[-1]))


def pad_side(side: Side, W: int) -> Side:
    """A side's factors of true width C in the padded layout of width W:
    h, q (and pv) (n, N, W), a1 (n, N, 2W: the hidden 2C first), [KV | Z]
    (n, W, 2W: KV at [:C, :C], Z at [:C, W:W + C]), zeros elsewhere."""
    C = side[0].shape[-1]
    if W == C:
        return side
    h, q, kvz, a1 = side[:4]
    kvzp = kvz.new_zeros((kvz.shape[0], W, 2 * W))
    kvzp[:, :C, :C] = kvz[:, :, :C]
    kvzp[:, :C, W:W + C] = kvz[:, :, C:]
    return ((_lanes(h, W), _lanes(q, W), kvzp, _lanes(a1, 2 * W))
            + tuple(_lanes(x, W) for x in side[4:]))


def pad_weights(w1, w2, W: int):
    """stage_weights' dicts of true width C in the padded layout of width
    W (made once per weight set): every vector and matrix zero past C on
    each side, fc1's rows as [search W | message W] and kv's columns as
    [Wk W | Wv W], the hidden 2C of 2W first."""
    C = w1["merge"].shape[0]
    if W == C:
        return w1, w2
    srcs = [w1[k] for k in sorted(w1)] + [w2[k] for k in sorted(w2)]
    return derived(srcs, ("match_pad", W),
                   lambda: (_pad_weights(w1, C, W), _pad_weights(w2, C, W)))


def _pad_weights(w, C: int, W: int):
    def mat(x, rows, cols):
        return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))
    out = {k: _lanes(x, W) for k, x in w.items() if x.dim() == 1}
    out["merge"] = mat(w["merge"], W, W)
    out["fc1"] = torch.cat([mat(w["fc1"][:C], W, 2 * W),
                            mat(w["fc1"][C:], W, 2 * W)])
    out["fc2"] = mat(w["fc2"], 2 * W, W)
    if "q" in w:
        out["q"] = mat(w["q"], W, W)
        out["kv"] = torch.cat([mat(w["kv"][:, :C], W, W),
                               mat(w["kv"][:, C:], W, W)], dim=1)
    return {k: v.contiguous() for k, v in out.items()}


def unpad_pooled(pooled: torch.Tensor, C: int) -> torch.Tensor:
    """[max | avg] of the true C channels from a (..., 2W) pooled output of
    the padded layout."""
    W = pooled.shape[-1] // 2
    if W == C:
        return pooled
    return torch.cat([pooled[..., :C], pooled[..., W:W + C]], dim=-1)


def padded_reference(t: Side, d: Side, w1, w2, nhead: int,
                     t_idx: torch.Tensor, d_idx: torch.Tensor, W: int
                     ) -> torch.Tensor:
    """The CPU model of a padded launch: the sides and weights laid out at
    width W, the chain with the kernels' masks (match_pooled_reference with
    ct), the pooled output sliced back: (P, 2C)."""
    C = t[0].shape[-1]
    pw1, pw2 = pad_weights(w1, w2, W)
    out = match_pooled_reference(pad_side(t, W), pad_side(d, W), pw1, pw2,
                                 nhead, t_idx, d_idx, ct=C)
    return unpad_pooled(out, C)


# ---- kernel wrappers ------------------------------------------------------------

# tiers
CLUSTER, ROWS, ROWS_MMA = range(3)
TIER_NAMES = ("cluster", "rows", "rows_mma")
MAX_SMEM = 232448       # 227 KB: a block's most dynamic shared memory, sm_90
SM_SMEM = 233472        # 228 KB: an SM's shared memory, 1 KB of it per block
CLUSTER_WIDTHS = (16, 64)
# the wgmma rows tier: 64, 128, and the wide kernel's multiples of 128
ROWS_WIDTHS = (64, 128) + tuple(range(256, 1025, 128))
ROWS_MMA_WIDTHS = (16,)             # the first rows kernel
ROWS_MAX_HEADS = 16                 # the wgmma rows tier's normalisers
WIDE_MAX_HEADS = 32                 # the wide kernel's (C > 128)
ROWS_MMA_MAX_HEADS = 8              # the first rows kernel's
ROWS_WARPS = 4                      # warps a block of the first rows kernel
ROWS_BLOCKS_PER_SM = 4


def tier_key(tier: int, bf16: bool) -> str:
    """The key of a tier's launches in a wrapper's `tier_launches`."""
    return TIER_NAMES[tier] + ("_bf16" if bf16 else "")


_ENTRIES = ("pcr_match_pooled", "pcr_match_rows_wg", "pcr_match_rows")


def layout_entry(tier: int, bf16: bool) -> str:
    """The C entry point of a tier's layout check at a dtype."""
    return _ENTRIES[tier] + ("_bf16" if bf16 else "") + "_layout"


class Plan(NamedTuple):
    tier: int           # CLUSTER, ROWS or ROWS_MMA
    smem: int           # dynamic shared bytes a block


def cluster_bytes(N: int, C: int) -> int:
    """Shared bytes of the cluster tier's layout (csrc/match_grid.cu
    Layout<C>::floats): weights 8 C^2 (and the 128-row k|v chunk where it
    does not fit among them), own O at Np x (C + 4), the peer's [KV | Z]
    2 C^2, pooling 8 x 2C + C + 2C."""
    c2, chunk = C * C, 128 * (2 * C + 8)
    weights = 8 * c2 + (0 if c2 + chunk <= 6 * c2 else chunk)
    Np = -(-N // 16) * 16
    return 4 * (weights + Np * (C + 4) + 2 * c2 + 8 * 2 * C + 3 * C)


def cluster_bytes_bf16(N: int, C: int) -> int:
    """Shared bytes of the bf16 cluster tier's layout
    (csrc/match_grid_bf16.cu Layout<C>::bytes): 1 KB to align the base, the
    15 C^2 weights and the C x C head mask and the peer's KV^T as K-major
    operands (rows of 128 bytes a 64-column panel), the buffer that holds
    [KV | Z] (2C x C), the summary's staging of two warpgroups (k^T 64 x 64
    and v^T C x 64 each) or the KV sum (128 x C / 2 floats), whichever is
    largest; own O at Np x C float32; sum k, the partials (8 x 2C) and the
    peer's pooling (2C), float32."""
    def op(rows, k):
        return rows * 128 * (-(-k // 64))
    weights = (op(C, C) + op(2 * C, C) + op(C, 2 * C) + op(C, C)
               + op(2 * C, C) + op(C, C) + op(2 * C, 2 * C) + op(C, 2 * C))
    ring = max(op(2 * C, C), 2 * (op(64, 64) + op(C, 64)), 128 * C // 2 * 4)
    Np = -(-N // 16) * 16
    return (1024 + weights + 2 * op(C, C) + ring + 4 * Np * C
            + 4 * (C + 8 * 2 * C + 2 * C))


# ---- the wgmma rows tier's layout (csrc/match_rows_wg.cuh Cfg) ----

RING_MAX = 16           # most weight stages in shared memory
WIDE_RING_MAX = 32      # the wide kernel's (C > 128)
STAGE_ROWS = 64         # output columns (B rows) a stage


class RowsLayout(NamedTuple):
    pk: int             # K columns a stage (one 128-byte panel)
    stage_bytes: int    # 64 rows x 128 bytes (bf16), or hi and lo (TF32)
    kvn: int            # columns of a KV m-tile's band: 64, 128 where a
                        # head has 128 channels, C on the wide kernel
    kv_stages: int      # message stages of a side's KV
    weight_stages: Tuple[int, int, int]   # a tile of stage 1, summary, stage 2
    ring: int           # stages in shared memory
    smem: int           # shared bytes a block


def rows_kvn(C: int, H: int) -> int:
    """The KV band of the rows tier for width C in H heads: 64 columns an
    m-tile of channels where a head has at most 64 channels, 128 where it
    has 128, and all C on the wide kernel (C > 128)."""
    D = C // H
    return C if C > 128 else (64 if D <= 64 else 128)


def rows_layout(C: int, H: int, dtype: torch.dtype = torch.float32
                ) -> RowsLayout:
    """The wgmma rows tier's layout for width C in H heads at `dtype`
    (bf16: one pass, 8 KB stages; float32: TF32 hi and lo, 16 KB): 1 KB to
    align the base, the ring, and the ring's mbarriers with one more for
    the summary's hand-off (the wide kernel's: for its scratch rows). At C
    <= 128: the summary staging of two warpgroups (C channels x 128 bytes
    of rows, k^T and v^T, at TF32 each with its lo array), sum k of each
    side and its partials (8 warps), the pooling partials (8 x 2C) and the
    normalisers (2 x 64 rows x 8 heads where H <= 8, else 16; the padded
    layout's are given H = ROWS_MAX_HEADS, layout_heads), float32, up to
    RING_MAX stages. On the wide kernel (C > 128, up to WIDE_RING_MAX
    stages) one layout at every width and head count, sized for MAX_C and
    WIDE_MAX_HEADS: the staging of a 128-column group's sum k or pooling
    (2 warpgroups x 4 warps x 128 x 2 floats), sum k of each side (2 x
    MAX_C) and the normalisers (2 x 64 rows x WIDE_MAX_HEADS); the summary
    streams its operands through the ring. The weight stages' counts are
    the same on both kernels; their order is weight_blocks'."""
    bf16 = dtype == BF16
    pk, sb, arrays = (64, 8192, 2) if bf16 else (32, 16384, 4)
    kvn = rows_kvn(C, H)
    nb, ch2, ppc, pph = C // 64, 2 * C // 64, C // pk, 64 // pk
    s1 = nb * pph * nb + ch2 * (ppc + pph * nb)
    if C > 128:
        most = WIDE_RING_MAX
        fixed = 4 * (2 * 4 * 128 * 2 + 2 * MAX_C + 2 * 64 * WIDE_MAX_HEADS)
    else:
        most = RING_MAX
        heads = 8 if H <= 8 else ROWS_MAX_HEADS
        # the staging, sum k, its partials, the pooling partials, the
        # normalisers
        fixed = 2 * arrays * C * 128 + 4 * (2 * C + 8 * C + 8 * 2 * C
                                            + 2 * 64 * heads)
    ring = min(most, (MAX_SMEM - 1024 - fixed - 8 * (2 * most + 1)) // sb)
    return RowsLayout(pk, sb, kvn, nb * (kvn // pk),
                      (s1, ch2 * ppc, ppc * nb + ch2 * ppc + s1), ring,
                      1024 + ring * sb + fixed + 8 * (2 * ring + 1))


def rows_bytes(C: int, H: int = 1) -> int:
    """Shared bytes of the float32 rows tier's layout (rows_layout; the
    heads change only the normalisers' rows, past 8)."""
    return rows_layout(C, H).smem


def rows_bytes_bf16(C: int, H: int = 1) -> int:
    """Shared bytes of the bf16 rows tier's layout (rows_layout)."""
    return rows_layout(C, H, BF16).smem


def rows_scratch_bytes(N: int, C: int, H: int,
                       dtype: torch.dtype = torch.float32) -> int:
    """Device scratch a block of the rows tier: both sides' KV as message
    stages, the stage-2 a = O fc1[:C] of an m-tile a side (2 x 64 x 2C
    float32) and both sides' stage-1 outputs O (2 x Np x C float32, Np = N
    rounded up to 64); on the wide kernel (C > 128, csrc/match_rows_wg.cuh
    WideScratch) no a (its FFN accumulates O fc1[:C]) but a side's operands
    in the stage layout, O's (Np / 64 x C / pk stages), k^T's and v^T's (as
    many each), q or the LayerNorm'd merge (C / pk), the message (C / pk)
    and the FFN's hidden rows (2C / pk), its parked LayerNorm groups (64 x
    (C - 128) float32) and its pooling row (2C float32)."""
    lay = rows_layout(C, H, dtype)
    Np = -(-N // 64) * 64
    kv_o = 2 * lay.kv_stages * lay.stage_bytes + 2 * Np * C * 4
    if C <= 128:
        return kv_o + 2 * 64 * 2 * C * 4
    ppc = C // lay.pk
    return kv_o + 2 * (lay.stage_bytes * ppc * (3 * Np // 64 + 4)
                       + 4 * 64 * (C - 128) + 4 * 2 * C)


def rows_mma_bytes(C: int) -> int:
    """Shared bytes of the first rows kernel's layout (csrc/match_rows.cu
    Layout<C>::FLOATS, tier ROWS_MMA): 4 warps x 16 rows x (2C + 4 + 2 (C +
    4)) strips, the summary C x (C + 8), ksum C, denominators 4 x 16 x 8,
    pooling 4 x 2C, two weight tiles of 32 x 72."""
    return 4 * (ROWS_WARPS * 16 * (4 * C + 12) + C * (C + 8) + C
                + ROWS_WARPS * 16 * ROWS_MMA_MAX_HEADS + ROWS_WARPS * 2 * C
                + 2 * 32 * 72)


def rows_mma_bytes_bf16(C: int) -> int:
    """Shared bytes of the first bf16 rows kernel's layout
    (csrc/match_rows_bf16.cu Layout<C>::BYTES): float32 strips of 4 warps x
    16 rows x (2C + 8 + 2 (C + 8)), the summary C x (C + 8), ksum C,
    denominators 4 x 16 x 8, pooling 4 x 2C; two bf16 weight tiles of 64 x
    72."""
    return (4 * (ROWS_WARPS * 16 * (4 * C + 24) + C * (C + 8) + C
                 + ROWS_WARPS * 16 * ROWS_MMA_MAX_HEADS + ROWS_WARPS * 2 * C)
            + 2 * 64 * 72 * 2)


MAX_C = 1024            # widest head the kernels serve (past it: K7)
# the rows tier's launches counted by shape (a wrapper's shape_launches)
SHAPE_KEYS = ("wide", "past_256", "many_heads", "past_16_heads")
K7 = "ROADMAP.md K7"


def kernel_width(C: int, tier: int) -> int:
    """The width W of the tier's instantiation that serves a head of C
    channels: C itself where the tier has one, else the smallest that
    holds it (the padded layout)."""
    widths = {CLUSTER: CLUSTER_WIDTHS, ROWS: ROWS_WIDTHS,
              ROWS_MMA: ROWS_MMA_WIDTHS}[tier]
    return next(w for w in widths if w >= C)


def max_heads(C: int) -> int:
    """The most heads the rows tier takes for a head of C channels:
    ROWS_MAX_HEADS up to 128 channels, WIDE_MAX_HEADS on the wide kernel."""
    return WIDE_MAX_HEADS if C > 128 else ROWS_MAX_HEADS


def plan(N: int, C: int, H: int, pos: bool = True,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The tier for sides of N rows and C channels in H heads, point head
    (`pos`) or image head: CLUSTER where its layout at width
    kernel_width(C, CLUSTER) fits in a block's shared memory (C <= 64, any
    heads), else ROWS_MMA for the point head at C = 16 in at most 8 heads,
    else ROWS (C <= 1024: the wide kernel past 128 at the next multiple of
    128; at most 16 heads up to 128 channels, 32 past them). Raises
    ValueError for a shape that none takes, past 1024 channels or past the
    heads max_heads(C) gives naming ROADMAP.md's K7. Each dtype has its own
    kernels: at bf16 the cluster tier's layout is cluster_bytes_bf16 (up to
    208 rows at C = 64) and the rows tiers' rows_bytes_bf16 /
    rows_mma_bytes_bf16; the rows tiers take the same widths and heads at
    both. The bytes are those of the width the tier runs at."""
    if N < 1 or H < 1 or C % H:
        raise ValueError(f"N={N}, C={C}, nhead={H}: want N >= 1 and nhead "
                         "dividing C")
    if C > MAX_C:
        raise ValueError(f"N={N}, C={C}, nhead={H}: the kernels take at most "
                         f"{MAX_C} channels ({K7})")
    bf16 = dtype == BF16
    if C <= CLUSTER_WIDTHS[-1]:
        cluster = (cluster_bytes_bf16 if bf16 else cluster_bytes)(
            N, kernel_width(C, CLUSTER))
        if cluster <= MAX_SMEM:
            return Plan(CLUSTER, cluster)
    _check_rows_heads(N, C, H)
    if pos and C in ROWS_MMA_WIDTHS and H <= ROWS_MMA_MAX_HEADS:
        return Plan(ROWS_MMA,
                    (rows_mma_bytes_bf16 if bf16 else rows_mma_bytes)(C))
    return Plan(ROWS, rows_layout(kernel_width(C, ROWS), layout_heads(
        C, H, 5 if pos else 4), dtype).smem)


def _check_rows_heads(N: int, C: int, H: int) -> None:
    if H > max_heads(C):
        raise ValueError(f"N={N}, C={C}, nhead={H}: the rows tier takes at "
                         f"most {max_heads(C)} heads at {C} channels ({K7})")


def rows_padded(C: int, H: int, parts: int) -> bool:
    """Whether the rows tier serves a head of C channels in H heads through
    its padded entry point (kernels' PAD instantiations): a width without an
    instantiation of its own, the image head (`parts` 4), heads of fewer
    than 8 channels (the exact instantiations read a head per 8-column
    n-tile) and every width of the wide kernel (C > 128)."""
    W = kernel_width(C, ROWS)
    return W != C or parts == 4 or C // H < 8 or W > 128


def layout_heads(C: int, H: int, parts: int) -> int:
    """The heads the rows tier's layout is sized for (its normalisers' rows;
    the H its layout check is given): H on the exact instantiations, whose
    normalisers hold 8 heads up to 8 and 16 past them, ROWS_MAX_HEADS in
    the padded layout, whose normalisers always hold 16, and
    WIDE_MAX_HEADS on the wide kernel."""
    if kernel_width(C, ROWS) > 128:
        return WIDE_MAX_HEADS
    return ROWS_MAX_HEADS if rows_padded(C, H, parts) else H


# device scratch bytes a rows-tier launch may take
ROWS_SCRATCH_BUDGET = 4 << 30


def rows_blocks(P: int, smem: int, device, scratch: int = 0) -> int:
    """Blocks of a rows-tier launch: as many as the card holds at once (by
    shared memory, at most ROWS_BLOCKS_PER_SM an SM), at most one a pair,
    and no more than ROWS_SCRATCH_BUDGET holds at `scratch` bytes a block
    (the wide kernel's scratch grows with C and N: ~28 MB a block at C =
    1024, N = 128 float32, ~139 MB at N = 2048)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(ROWS_BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    most = sms * per_sm
    if scratch > 0:
        most = min(most, ROWS_SCRATCH_BUDGET // scratch)
    return max(1, min(P, most))


# ---- the rows tier's stage copies ----

def _k_order(pk: int, natural: bool = False) -> torch.Tensor:
    """The real K column at each k position of a stage: identity at bf16
    and where A comes from shared memory too (`natural`: the wide kernel);
    else at TF32 columns 2t, 2t + 1 of each 8-group at positions t, t + 4
    (the A fragments of csrc/tf32_mma.cuh a_from_acc)."""
    p = torch.arange(pk)
    if pk == 64 or natural:
        return p
    q = p % 8
    return p - q + torch.where(q < 4, 2 * q, 2 * (q - 4) + 1)


@functools.lru_cache(maxsize=64)
def _stage_index(blocks: Tuple[Tuple[int, int], ...], pk: int, device,
                 natural: bool = False):
    rows = torch.tensor([b[0] for b in blocks])[:, None] + torch.arange(
        STAGE_ROWS)
    cols = torch.tensor([b[1] for b in blocks])[:, None] + _k_order(
        pk, natural)
    # unit u (16 bytes) of row r lies at unit u ^ (r % 8): read unit v ^ (r % 8)
    swz = torch.arange(8)[None, :] ^ (torch.arange(STAGE_ROWS)[:, None] % 8)
    return rows.to(device), cols.to(device), swz.to(device)


def b_stages(mat: torch.Tensor, blocks, bf16: bool,
             natural: bool = False) -> torch.Tensor:
    """B-operand stages of the rows tier cut from mat (..., R, K) float32,
    R the product's output columns and K its contraction: block (r0, k0)
    is rows r0 .. r0 + 63 and one k-panel from k0 (64 columns at bf16, 32
    at TF32), K-major with the 128-byte swizzle of csrc/bf16_mma.cuh (16-byte
    unit u of row r at u ^ (r % 8)). bf16: the panel rounded to bf16, 4,096
    values a stage. TF32: K in the order of _k_order (`natural`: the wide
    kernel's), then hi (the value with TF32's low 13 mantissa bits cleared)
    and lo = value - hi, 2,048 floats each. The wide kernel's A stages of
    its scratch rows lie the same way (R its 64 rows). Returns (...,
    blocks x 4,096) in bf16 or float32."""
    pk = 64 if bf16 else 32
    rows, cols, swz = _stage_index(tuple(blocks), pk, mat.device, natural)
    x = mat[..., rows[:, :, None], cols[:, None, :]]   # (..., nb, 64, pk)
    unit = 8 if bf16 else 4
    x = x.reshape(*x.shape[:-1], 8, unit)
    x = torch.gather(x, -2, swz[:, :, None].expand(x.shape[-3:]).expand(
        x.shape).contiguous())
    lead = x.shape[:-4]
    nb = len(blocks)
    if bf16:
        return x.to(BF16).reshape(*lead, nb * 4096)
    x = x.reshape(*lead, nb, 2048).contiguous()
    hi = (x.view(torch.int32) & -8192).view(torch.float32)
    return torch.cat([hi, x - hi], dim=-1).reshape(*lead, nb * 4096)


def _tail_blocks(C: int, pk: int, merge: str, fc1b: str, fc2: str) -> list:
    """A tile's weight stages of the chain's tail in the order the rows
    tier takes them: for each 64-column message chunk j its merge stages
    (k-panels of the chunk, each for the 64-column blocks of the output);
    then for each 64-column hidden chunk h its fc1[C:] stages (k-panels
    over C) and fc2 stages (k-panels of the chunk x output blocks)."""
    nb, pph = C // 64, 64 // pk
    seq = [(merge, 64 * rb, 64 * j + qq * pk) for j in range(nb)
           for qq in range(pph) for rb in range(nb)]
    for h in range(2 * C // 64):
        seq += [(fc1b, 64 * h, p * pk) for p in range(C // pk)]
        seq += [(fc2, 64 * rb, 64 * h + qq * pk) for qq in range(pph)
                for rb in range(nb)]
    return seq


def _groups(name: str, R: int, K: int, pk: int) -> list:
    """The stages of an R-wide product over K in the wide kernel's order:
    each 128-column group of the output (a half of a C-wide one), k-panel
    by k-panel, its two 64-column blocks a panel."""
    return [(name, 128 * g + 64 * rb, p * pk) for g in range(R // 128)
            for p in range(K // pk) for rb in range(2)]


def _wide_tail_blocks(C: int, pk: int, merge: str, fc1b: str,
                      fc2: str) -> list:
    """A tile's weight stages of the chain's tail on the wide kernel (C >
    128): merge in halves, fc1[C:] in 128-column groups of the 2C hidden
    columns, fc2 in halves over them."""
    return (_groups(merge, C, C, pk) + _groups(fc1b, 2 * C, C, pk)
            + _groups(fc2, C, 2 * C, pk))


def weight_blocks(C: int, pk: int) -> list:
    """(matrix, row0, k0) of every weight stage of the rows tier in the
    order its producer streams them (csrc/match_rows_wg.cuh): a stage-1
    tile (the tail of stage 1), a summary tile ([Wk | Wv], 64-column chunks
    x k-panels), a stage-2 tile (Wq by k-panel x output block, fc1[:C] by
    hidden chunk x k-panel, the tail of stage 2). On the wide kernel (C >
    128) every product comes in 128-column groups (_groups), [Wk | Wv]
    streamed once a summary tile, stage 2's hidden groups taking fc1[:C]'s
    group (over O) before fc1[C:]'s, and the kernel's producer puts the A
    stages of its scratch rows between them."""
    nb, ch2, ppc = C // 64, 2 * C // 64, C // pk
    if C > 128:
        hidden2 = []
        for g in range(2 * C // 128):
            hidden2 += (_groups("fc1a2", 2 * C, C, pk)[g * 2 * ppc:
                                                       (g + 1) * 2 * ppc]
                        + _groups("fc1b2", 2 * C, C, pk)[g * 2 * ppc:
                                                         (g + 1) * 2 * ppc])
        return (_wide_tail_blocks(C, pk, "merge1", "fc1b1", "fc2_1")
                + _groups("kv2", 2 * C, C, pk) + _groups("q2", C, C, pk)
                + _groups("merge2", C, C, pk) + hidden2
                + _groups("fc2_2", C, 2 * C, pk))
    seq = _tail_blocks(C, pk, "merge1", "fc1b1", "fc2_1")
    seq += [("kv2", 64 * i, p * pk) for i in range(ch2) for p in range(ppc)]
    seq += [("q2", 64 * rb, p * pk) for p in range(ppc) for rb in range(nb)]
    seq += [("fc1a2", 64 * h, p * pk) for h in range(ch2)
            for p in range(ppc)]
    return seq + _tail_blocks(C, pk, "merge2", "fc1b2", "fc2_2")


def _weight_matrices(w1, w2) -> Dict[str, torch.Tensor]:
    """The rows tier's B operands in (out, in) layout from the (in, out)
    weight dicts of stage_weights."""
    C = w1["merge"].shape[0]
    return dict(merge1=w1["merge"].t(), fc1b1=w1["fc1"][C:].t(),
                fc2_1=w1["fc2"].t(), kv2=w2["kv"].t(), q2=w2["q"].t(),
                fc1a2=w2["fc1"][:C].t(), merge2=w2["merge"].t(),
                fc1b2=w2["fc1"][C:].t(), fc2_2=w2["fc2"].t())


def rows_stage_weights(w1, w2, bf16: bool) -> torch.Tensor:
    """The rows tier's weight stages (weight_blocks' order, b_stages'
    layout) made once per weight set: bf16 for a bf16 model, TF32 hi / lo
    float32 for a float32 one."""
    srcs = [w1[k] for k in sorted(w1)] + [w2[k] for k in sorted(w2)]
    return derived(srcs, ("match_rows_stages", bf16),
                   lambda: _rows_stage_weights(w1, w2, bf16))


def _rows_stage_weights(w1, w2, bf16: bool) -> torch.Tensor:
    C = w1["merge"].shape[0]
    mats = _weight_matrices(w1, w2)
    seq = weight_blocks(C, 64 if bf16 else 32)
    cut = {name: b_stages(m.float(), [(r, k) for n, r, k in seq if n == name],
                          bf16, natural=C > 128).reshape(-1, 4096)
           for name, m in mats.items()}
    taken = dict.fromkeys(mats, 0)
    out = []
    for name, _, _ in seq:
        out.append(cut[name][taken[name]])
        taken[name] += 1
    return torch.stack(out).reshape(-1).contiguous()


def message_blocks(C: int, H: int, pk: int) -> list:
    """(row0, k0) of a side's KV message stages: for each 64-column output
    chunk j, the k-panels of its heads' band (rows_kvn columns from the
    band's start: 64 from 64 j, 128 from 0 at C = 128 in 128-channel heads,
    all C on the wide kernel)."""
    kvn = rows_kvn(C, H)
    return [(64 * j, 64 * j // kvn * kvn + b * pk)
            for j in range(C // 64) for b in range(kvn // pk)]


def message_stages(kvz: torch.Tensor, H: int, bf16: bool):
    """The stage-1 message operands of a side from its [KV | Z] factor (n,
    C, 2C): KV^T's band as message stages (n, stages x 4,096; K in the
    wide kernel's natural order past 128 channels) and sum k, Z's
    diagonal, (n, C) float32."""
    C = kvz.shape[1]
    kvt = kvz[:, :, :C].transpose(1, 2).float()
    stages = b_stages(kvt, message_blocks(C, H, 64 if bf16 else 32), bf16,
                      natural=C > 128)
    ks = torch.diagonal(kvz[:, :, C:], dim1=1, dim2=2).float().contiguous()
    return stages.contiguous(), ks

def _check_side(side: Side, N: int, C: int, device, name: str,
                dtype: torch.dtype = torch.float32) -> int:
    n = side[0].shape[0]
    shapes = ((n, N, C), (n, N, C), (n, C, 2 * C), (n, N, 2 * C), (n, N, C))
    for x, want, part in zip(side, shapes, _PARTS):
        if (tuple(x.shape) != want or x.dtype != dtype
                or not x.is_contiguous() or x.device != device
                or x.data_ptr() % 16):
            raise ValueError(f"{name}.{part}: want contiguous, 16-byte "
                             f"aligned {dtype} {want} on {device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return n


def launch(counter, parts: int, t: Side, d: Side, w1, w2, nhead: int,
           t_idx: Optional[torch.Tensor], d_idx: Optional[torch.Tensor],
           library: Optional[_lib.Library] = None,
           tier: Optional[int] = None) -> torch.Tensor:
    """Check the inputs, launch the tier plan(N, C, nhead) picks for sides
    of `parts` tensors (grid mode when t_idx is None) and add one to
    `counter.launches`, and to its tier's count, once the launch succeeded.
    bf16 sides launch the bf16 tier (csrc/match_grid_bf16.cu or
    csrc/match_rows_bf16.cu; the weights as stage_weights gives them,
    handed to the kernel converted once; out bf16) and count in
    `counter.bf16_launches` and in the tier's `<tier>_bf16` count. The rows
    tier takes its weights as rows_stage_weights lays them out and each
    side's [KV | Z] as message_stages; the others the matrices in (out, in)
    layout at bf16, (in, out) at float32.
    A width C the tier has no instantiation for runs at kernel_width(C,
    tier) in the padded layout (pad_side, pad_weights) through the tier's
    `_pad` entry point, which is given the true C and masks the padded
    lanes; so does the image head on the rows tier (its `_pad` entry takes
    no position term). Such a launch also counts in
    `counter.padded_launches` by tier; the output is sliced back to 2C.
    The rows tier's launches on the wide kernel (W > 128), on it past 256
    channels, with more than 8 heads and with more than 16 also count in
    `counter.shape_launches` ("wide", "past_256", "many_heads",
    "past_16_heads", each also with "_bf16").
    `library` is another build of the kernels' entry points, as
    tools/ab_match.py times versions of them; it passes no counter. A build
    without the rows tier's entry points (an earlier csrc/match_rows*.cu)
    is launched through the first rows kernel's, at its own layout. `tier`
    (ROWS) drives the rows tier at a shape the plan gives another tier, as
    the card's tests and tools/ab_match.py do; the wrappers never pass
    it."""
    device = t[0].device
    N, C = t[0].shape[1], t[0].shape[2]
    bf16 = t[0].dtype == BF16
    dt = BF16 if bf16 else torch.float32
    sfx = "_bf16" if bf16 else ""
    nt = _check_side(t, N, C, device, "track", dt)
    nd = _check_side(d, N, C, device, "det", dt)
    how = plan(N, C, nhead, pos=parts == 5, dtype=dt)
    if tier == ROWS and how.tier != ROWS:
        _check_rows_heads(N, C, nhead)
        how = Plan(ROWS, rows_layout(kernel_width(C, ROWS), layout_heads(
            C, nhead, parts), dt).smem)
    elif tier not in (None, how.tier):
        raise ValueError(f"N={N}, C={C}, nhead={nhead}: the {TIER_NAMES[tier]}"
                         f" tier does not take this shape")
    lib = (library or _lib.LIBRARY).get()
    tier = how.tier
    W = kernel_width(C, tier)
    padded = W != C or (tier == ROWS and rows_padded(C, nhead, parts))
    if tier == ROWS and not hasattr(lib, layout_entry(ROWS, bf16)):
        tier = ROWS_MMA     # an earlier build: its one rows kernel
    entry = (_ENTRIES[tier] + ("_image" if tier == CLUSTER and parts == 4
                               else "") + ("_pad" if padded else "") + sfx)
    if not hasattr(lib, entry):
        raise ValueError(f"N={N}, C={C}, nhead={nhead}: this build has no "
                         f"{entry}")
    # the padded entries take the heads apart from the layout (the rows
    # tier's KV band then spans every column; its normalisers hold 16 heads)
    hl = 1 if padded else nhead
    smem, limit = ctypes.c_longlong(), ctypes.c_longlong()
    status = getattr(lib, layout_entry(tier, bf16))(
        N, W, layout_heads(C, nhead, parts) if tier == ROWS else hl,
        ctypes.byref(smem), ctypes.byref(limit))
    if status or (tier == how.tier and smem.value != how.smem):
        # a build whose layout differs from the plan's
        raise ValueError(
            f"{TIER_NAMES[tier]} tier, N={N}, C={C}, nhead={nhead}: the "
            f"kernel's layout check says {status} ({smem.value} bytes of "
            f"{limit.value}; the plan's {how.smem})")
    if padded:
        t, d = pad_side(t, W), pad_side(d, W)
        w1, w2 = pad_weights(w1, w2, W)
    ws = {"w1": w1, "w2": w2}
    weights = [ws[g][k] for g, k in _WEIGHT_ORDER]
    for (g, k), x in zip(_WEIGHT_ORDER, weights):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != device or x.data_ptr() % 16):
            raise ValueError(f"{g}.{k}: want contiguous, 16-byte aligned "
                             f"float32 on {device}")
    if t_idx is None:
        P = nt * nd
        out = torch.empty((nt, nd, 2 * W), dtype=dt, device=device)
        idx_ptrs = [None, None]
    else:
        P = t_idx.shape[0]
        for x in (t_idx, d_idx):
            if (x.shape != (P,) or x.dtype != torch.int32
                    or not x.is_contiguous() or x.device != device):
                raise ValueError("pair indices: want contiguous int32 (P,) "
                                 f"on {device}")
        check_pair_range(t_idx, d_idx, nt, nd)
        out = torch.empty((P, 2 * W), dtype=dt, device=device)
        idx_ptrs = [t_idx.data_ptr(), d_idx.data_ptr()]
    if P == 0:
        return unpad_pooled(out, C)
    stream = _lib.stream_ptr(device)
    shape = [nt, nd, P, N, W, nhead] + ([C] if padded else [])
    if tier == ROWS:
        sides = []      # the tensors stay referenced until the launch
        for s in (t, d):
            sides += [s[0], s[1], s[3], s[4] if parts == 5 else None,
                      *message_stages(s[2], hl, bf16)]
        stages = rows_stage_weights(w1, w2, bf16)
        ln = [w[k] for w in (w1, w2) for k in ("ln1_scale", "ln1_bias",
                                               "ln2_scale", "ln2_bias")]
        stride = rows_scratch_bytes(N, W, hl, dt)
        blocks = rows_blocks(P, smem.value, device, stride)
        scratch = torch.empty((blocks, stride), dtype=torch.uint8,
                              device=device)
        err = getattr(lib, entry)(
            *[None if x is None else x.data_ptr()
              for x in sides + [stages] + ln], *idx_ptrs,
            out.data_ptr(), scratch.data_ptr(), *shape, blocks, stride,
            stream)
    else:
        if bf16:
            weights = [x if x.dim() == 1 else derived(
                (x,), "match_bf16", lambda x=x: x.t().to(BF16).contiguous())
                for x in weights]
            # [KV | Z] is a B operand of the kernel: (n, 2C, C)
            t, d = (s[:2] + (s[2].transpose(1, 2).contiguous(),) + s[3:]
                    for s in (t, d))
        ptrs = [*[x.data_ptr() for x in t], *[x.data_ptr() for x in d],
                *[x.data_ptr() for x in weights], *idx_ptrs, out.data_ptr()]
        if tier == CLUSTER:
            err = getattr(lib, entry)(*ptrs, *shape, stream)
        else:
            blocks = rows_blocks(P, smem.value, device)
            Np = -(-N // 16) * 16
            scratch = torch.empty((blocks, 2, Np, C), dtype=torch.float32,
                                  device=device)
            err = getattr(lib, entry)(*ptrs, scratch.data_ptr(), *shape,
                                      blocks, stream)
    _lib.check(err, entry)
    if counter is not None:
        if bf16:
            counter.bf16_launches += 1
        else:
            counter.launches += 1
        counter.tier_launches[tier_key(tier, bf16)] += 1
        if padded:
            counter.padded_launches[tier_key(tier, bf16)] += 1
        for key, on in (("wide", W > 128), ("past_256", W > 256),
                        ("many_heads", nhead > 8),
                        ("past_16_heads", nhead > 16)):
            if tier == ROWS and on:
                counter.shape_launches[key + sfx] += 1
    return unpad_pooled(out, C)


def _check_parts(parts: int, t: Side, d: Side) -> None:
    if len(t) != parts or len(d) != parts:
        raise ValueError(f"want sides of {parts} tensors {_PARTS[:parts]}, "
                         f"got {len(t)} and {len(d)}")


def _grid(counter, parts: int, t: Side, d: Side, w1, w2, nhead: int):
    _check_parts(parts, t, d)
    device = t[0].device
    if device.type == "cpu":
        nt, nd = t[0].shape[0], d[0].shape[0]
        ti = torch.arange(nt).repeat_interleave(nd)
        di = torch.arange(nd).repeat(nt)
        return match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                      ).reshape(nt, nd, -1)
    if device.type != "cuda":
        raise RuntimeError(f"{counter.__name__}: no kernel for {device}")
    return launch(counter, parts, t, d, w1, w2, nhead, None, None)


def _pairs(counter, parts: int, t: Side, d: Side, w1, w2, nhead: int,
           t_idx: torch.Tensor, d_idx: torch.Tensor):
    _check_parts(parts, t, d)
    device = t[0].device
    if device.type == "cpu":
        return match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    if device.type != "cuda":
        raise RuntimeError(f"{counter.__name__}: no kernel for {device}")
    return launch(counter, parts, t, d, w1, w2, nhead,
                  t_idx.to(torch.int32).contiguous(),
                  d_idx.to(torch.int32).contiguous())


def fused_match_grid(t: Side, d: Side, w1, w2, nhead: int) -> torch.Tensor:
    """All-pairs pooled match features of the point head: (nt, nd, 2C)."""
    return _grid(fused_match_grid, 5, t, d, w1, w2, nhead)


def fused_match_pairs(t: Side, d: Side, w1, w2, nhead: int,
                      t_idx: torch.Tensor, d_idx: torch.Tensor
                      ) -> torch.Tensor:
    """Pair-list pooled match features of the point head: row p scores
    (t_idx[p], d_idx[p]), read straight from the per-object factors. Returns
    (P, 2C). Indices outside [0, nt) x [0, nd) raise IndexError on either
    device."""
    return _pairs(fused_match_pairs, 5, t, d, w1, w2, nhead, t_idx, d_idx)


def fused_image_match_grid(t: Side, d: Side, w1, w2, nhead: int
                           ) -> torch.Tensor:
    """fused_match_grid for the image head: sides of four tensors
    (image_grid_factors), S tokens a side, no position term."""
    return _grid(fused_image_match_grid, 4, t, d, w1, w2, nhead)


def fused_image_match_pairs(t: Side, d: Side, w1, w2, nhead: int,
                            t_idx: torch.Tensor, d_idx: torch.Tensor
                            ) -> torch.Tensor:
    """fused_match_pairs for the image head."""
    return _pairs(fused_image_match_pairs, 4, t, d, w1, w2, nhead, t_idx,
                  d_idx)


for _fn in (fused_match_grid, fused_match_pairs, fused_image_match_grid,
            fused_image_match_pairs):
    _fn.launches = 0
    # launches by tier and dtype, beside the totals
    _fn.tier_launches = {tier_key(t, b): 0 for b in (False, True)
                         for t in range(len(TIER_NAMES))}
    # of those, the launches in the padded layout (a width the tier has no
    # instantiation for; on the rows tier also the image head, heads of
    # fewer than 8 channels and the wide kernel: rows_padded)
    _fn.padded_launches = dict(_fn.tier_launches)
    # of those, the rows tier's on its wide kernel (C > 128), on it past
    # 256 channels, and with more than 8 and more than 16 heads
    _fn.shape_launches = {k + b: 0 for k in SHAPE_KEYS
                          for b in ("", "_bf16")}
    _fn.bf16_launches = 0


# ---- model-level scorers ---------------------------------------------------------

def match_factors(model, h_t, xyz_t, h_d, xyz_d):
    """(track factors, det factors, w1, w2, nhead) of a ReIDNet's cross
    stages: the kernel's inputs."""
    s1, s2 = model.cross_stage1, model.cross_stage2
    nhead = s1.nhead
    t = grid_factors(s1, s2, h_t, xyz_t, nhead)
    d = grid_factors(s1, s2, h_d, xyz_d, nhead)
    w1, w2 = stage_weights(s1, s2)
    return t, d, w1, w2, nhead


def fused_head_ok(model, image_mode: bool = False) -> bool:
    """Whether the fused kernels compute `model`'s match head: the chain
    they hard-code, xcorr_eff over two plain linear cross stages, combine
    'point-cat', max+avg pooling; corss_attention stages on a ReIDNet,
    cross_lin_attn (the same chain without positions) on an ImageReIDNet
    with image_mode. The port of the JAX scorer's _pallas_grid_ok
    (inference/pair_scoring.py) without its backend clause: on the CPU the
    wrappers run their plain versions. Every head it refuses is scored by
    the model's own match_logits_grid / match_logits, as in JAX."""
    name, stage = (("ImageReIDNet", "CrossLinAttn") if image_mode
                   else ("ReIDNet", "CrossAttentionBlock"))
    if type(model).__name__ != name:
        return False
    stages = (model.cross_stage1, model.cross_stage2)
    return (model.match_type == "xcorr_eff"
            and model.combine == "point-cat"
            and model.pool_type == "both"
            and all(type(s).__name__ == stage and s.attention == "linear"
                    for s in stages))


def grid_logits(model, h_t, xyz_t, h_d, xyz_d) -> torch.Tensor:
    """Factors -> fused grid kernel -> match head: (nt, nd) logits. Drop-in
    equivalent of ReIDNet.match_logits_grid for the heads fused_head_ok
    accepts; any other head (another match type, another attention
    primitive) is scored by match_logits_grid itself and launches no match
    kernel."""
    if not fused_head_ok(model):
        return model.match_logits_grid(h_t, xyz_t, h_d, xyz_d)
    t, d, w1, w2, nhead = match_factors(model, h_t, xyz_t, h_d, xyz_d)
    pooled = fused_match_grid(t, d, w1, w2, nhead)
    nt, nd = pooled.shape[:2]
    return model.match_head(pooled.reshape(nt * nd, -1))[:, 0].reshape(nt, nd)


def pair_logits(model, h_t, xyz_t, h_d, xyz_d, t_idx, d_idx) -> torch.Tensor:
    """Gated sparse scoring: (P,) logits of the listed (track, det) pairs,
    equal to grid_logits(...)[t_idx, d_idx]; a head fused_head_ok refuses
    is scored by match_logits over the gathered pairs, as JAX's
    xla_pair_logits (in chunks: ReIDNet.match_logits_pairs)."""
    if not fused_head_ok(model):
        return model.match_logits_pairs(h_t, xyz_t, h_d, xyz_d, t_idx, d_idx)
    t, d, w1, w2, nhead = match_factors(model, h_t, xyz_t, h_d, xyz_d)
    pooled = fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    return model.match_head(pooled)[:, 0]


def check_image_head(model) -> None:
    """Raise unless `model` is an ImageReIDNet: the image scorers' models.
    Its head need not be the chain the kernel computes (fused_head_ok with
    image_mode): any other is scored by the model's own path."""
    if type(model).__name__ != "ImageReIDNet":
        raise TypeError(f"image scoring needs an ImageReIDNet, got "
                        f"{type(model).__name__}")


def image_match_factors(model, h_t, h_d):
    """(track factors, det factors, w1, w2, nhead) of an ImageReIDNet's
    cross stages: the image kernel's inputs."""
    s1, s2 = model.cross_stage1, model.cross_stage2
    nhead = s1.nhead
    t = image_grid_factors(s1, h_t, nhead)
    d = image_grid_factors(s1, h_d, nhead)
    w1, w2 = stage_weights(s1, s2)
    return t, d, w1, w2, nhead


def image_grid_logits(model, h_t, h_d) -> torch.Tensor:
    """Factors -> fused image grid kernel -> match head: (nt, nd) logits of
    (nt/nd, S, C) downsampled token features. Drop-in equivalent of
    ImageReIDNet.match_logits_grid; a head fused_head_ok(image_mode=True)
    refuses (another combine, pooling or match type, another attention
    primitive) is scored by match_logits_grid itself, as JAX's scorer does,
    and launches no match kernel."""
    check_image_head(model)
    if not fused_head_ok(model, image_mode=True):
        return model.match_logits_grid(h_t, h_d)
    t, d, w1, w2, nhead = image_match_factors(model, h_t, h_d)
    pooled = fused_image_match_grid(t, d, w1, w2, nhead)
    nt, nd = pooled.shape[:2]
    return model.match_head(pooled.reshape(nt * nd, -1))[:, 0].reshape(nt, nd)


def image_pair_logits(model, h_t, h_d, t_idx, d_idx) -> torch.Tensor:
    """Gated sparse image scoring: (P,) logits of the listed (track, det)
    pairs, equal to image_grid_logits(...)[t_idx, d_idx]; a head
    fused_head_ok refuses is scored by match_logits over the gathered
    pairs, as JAX's xla_image_pair_logits."""
    check_image_head(model)
    if not fused_head_ok(model, image_mode=True):
        t_idx, d_idx = t_idx.long(), d_idx.long()
        return model.match_logits(h_t[t_idx], h_d[d_idx])
    t, d, w1, w2, nhead = image_match_factors(model, h_t, h_d)
    pooled = fused_image_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    return model.match_head(pooled)[:, 0]


# ---- sharded scoring -------------------------------------------------------------

def kernel_launches() -> Dict[str, int]:
    """Match-kernel and SA-kernel launches so far, both dtypes."""
    match = sum(fn.launches + fn.bf16_launches for fn in (
        fused_match_grid, fused_match_pairs, fused_image_match_grid,
        fused_image_match_pairs))
    return dict(match=match, sa=fused_sa_convmax.launches
                + fused_sa_convmax.bf16_launches)


def shard_bounds(n: int, parts: int):
    """[(lo, hi)] of `parts` contiguous shards of n rows (the first n %
    parts one row longer)."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def run_sharded(mesh, n: int, fn):
    """fn(model device, lo, hi) for each non-empty contiguous shard of n
    rows, entry by entry (one shard, on the first entry, when n is 0);
    returns the results in entry order. Each entry's kernel launches are
    added to mesh.launches."""
    shards = [(i, dev, lo, hi) for i, (dev, (lo, hi)) in enumerate(
        zip(mesh.flat, shard_bounds(n, mesh.size))) if hi > lo]
    out = []
    for i, dev, lo, hi in shards or [(0, mesh.flat[0], 0, 0)]:
        before = kernel_launches()
        out.append(fn(dev, lo, hi))
        for k, v in kernel_launches().items():
            mesh.launches[i][k] += v - before[k]
    return out


def sharded_grid_logits(model, h_t, xyz_t, h_d, xyz_d, mesh) -> torch.Tensor:
    """grid_logits with the detections in contiguous shards over the mesh
    entries and the tracks copied to each; the (nt, nd) logits on the
    first entry's device."""
    first = mesh.flat[0]

    def shard(dev, lo, hi):
        return grid_logits(model_on(model, dev), h_t.to(dev), xyz_t.to(dev),
                           h_d[lo:hi].to(dev), xyz_d[lo:hi].to(dev)).to(first)
    return torch.cat(run_sharded(mesh, h_d.shape[0], shard), dim=1)


def sharded_pair_logits(model, h_t, xyz_t, h_d, xyz_d, t_idx, d_idx, mesh
                        ) -> torch.Tensor:
    """pair_logits with the pair list in contiguous shards over the mesh
    entries, every entry computing the factors of both sides; the (P,)
    logits on the first entry's device."""
    first = mesh.flat[0]

    def shard(dev, lo, hi):
        return pair_logits(model_on(model, dev), h_t.to(dev), xyz_t.to(dev),
                           h_d.to(dev), xyz_d.to(dev), t_idx[lo:hi].to(dev),
                           d_idx[lo:hi].to(dev)).to(first)
    return torch.cat(run_sharded(mesh, t_idx.shape[0], shard))


def sharded_image_grid_logits(model, h_t, h_d, mesh) -> torch.Tensor:
    """image_grid_logits with the detections' tokens in contiguous shards
    over the mesh entries."""
    first = mesh.flat[0]

    def shard(dev, lo, hi):
        return image_grid_logits(model_on(model, dev), h_t.to(dev),
                                 h_d[lo:hi].to(dev)).to(first)
    return torch.cat(run_sharded(mesh, h_d.shape[0], shard), dim=1)


def sharded_image_pair_logits(model, h_t, h_d, t_idx, d_idx, mesh
                              ) -> torch.Tensor:
    """image_pair_logits with the pair list in contiguous shards over the
    mesh entries."""
    first = mesh.flat[0]

    def shard(dev, lo, hi):
        return image_pair_logits(model_on(model, dev), h_t.to(dev),
                                 h_d.to(dev), t_idx[lo:hi].to(dev),
                                 d_idx[lo:hi].to(dev)).to(first)
    return torch.cat(run_sharded(mesh, t_idx.shape[0], shard))
