"""Tier C of the kNN kernel (csrc/knn_channels.cu) walked on the CPU.

  - (a) the selection: a numpy model of a warp's walk over one query's
    tiles, lane by lane: the first tile's candidates sorted into the list
    (one network for all the warp's queries); then each candidate under the
    k-th key (a register copy; two ballots a query a tile) appended to the
    pending buffer, the buffer merged first when the tile's candidates would
    overflow it, a tile of more than PENDING merged straight in, through the
    bitonic networks (sort 32 or 64, the list against the batch reversed,
    its bitonic merge). It gives the first k of a stable argsort on exact,
    duplicated and random distances, at k = 1, 20, 32, 33 and 64, N off
    the 64-point tile and N = k, whatever the order of the appends;
  - (b) the plan of the new layout: shared bytes and strides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import knn as kk  # noqa: E402
from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

LANES = np.arange(32)
NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
# the kernel's constants (csrc/knn_channels.cu)
ROWS, PENDING = 64, kk.CH_PENDING


def order_key(d: np.ndarray) -> np.ndarray:
    """The kernel's uint32 key of a float32 distance (-0 as +0)."""
    u = (np.asarray(d, np.float32) + np.float32(0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def pack(key: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return (key.astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)


def exchange(x, stride, keep_min):
    y = x[LANES ^ stride]
    return np.where(keep_min, np.minimum(x, y), np.maximum(x, y))


def sort64(x0, x1):
    for size in (2, 4, 8, 16, 32, 64):
        stride = size >> 1
        while stride:
            if stride == 32:
                x0, x1 = np.minimum(x0, x1), np.maximum(x0, x1)
            else:
                low = (LANES & stride) == 0
                x0 = exchange(x0, stride, ((LANES & size) == 0) == low)
                x1 = exchange(x1, stride, (((LANES + 32) & size) == 0) == low)
            stride >>= 1
    return x0, x1


def sort32(x):
    for size in (2, 4, 8, 16, 32):
        stride = size >> 1
        while stride:
            x = exchange(x, stride,
                         ((LANES & size) == 0) == ((LANES & stride) == 0))
            stride >>= 1
    return x


class Query:
    """One query's state in its warp: the sorted list (e0, e1: entries lane
    and lane + 32), the k-th key `thr`, the pending buffer."""

    def __init__(self, k: int, order=None):
        self.k, self.two = k, k > 32
        self.e0 = np.full(32, NONE)
        self.e1 = np.full(32, NONE)
        self.thr = 0xFFFFFFFF
        self.pend = np.full(PENDING, NONE)
        self.cnt = 0
        self.merges = 0
        self.order = order      # a RandomState shuffling the appends

    def set_thr(self):
        kth = (self.e1 if self.two else self.e0)[(self.k - 1) & 31]
        self.thr = int(kth >> np.uint64(32))

    def merge(self, x0, x1, wide: bool):
        if wide:
            x0, x1 = sort64(x0, x1)
        else:
            x0 = sort32(x0)
        src = 31 - LANES
        if self.two:
            self.e0 = np.minimum(self.e0, x1[src])
            self.e1 = np.minimum(self.e1, x0[src])
            self.e0, self.e1 = (np.minimum(self.e0, self.e1),
                                np.maximum(self.e0, self.e1))
        else:
            self.e0 = np.minimum(self.e0, x0[src])
        for stride in (16, 8, 4, 2, 1):
            low = (LANES & stride) == 0
            self.e0 = exchange(self.e0, stride, low)
            if self.two:
                self.e1 = exchange(self.e1, stride, low)
        self.set_thr()
        self.merges += 1

    def flush(self):
        batch = np.full(32, NONE)
        batch[:self.cnt] = self.pend[:self.cnt]
        self.merge(batch, np.full(32, NONE), False)
        self.cnt = 0

    def first(self, keys: np.ndarray, N: int):
        """The first tile: its candidates sorted (one network for the
        warp's queries) become the list."""
        i0 = 2 * LANES
        x0 = np.where(i0 < N, pack(keys[0::2], i0), NONE)
        x1 = np.where(i0 + 1 < N, pack(keys[1::2], i0 + 1), NONE)
        self.e0, self.e1 = sort64(x0, x1)
        self.set_thr()
        self.merges += 1

    def take(self, keys: np.ndarray, base: int, N: int):
        """A later tile's 64 keys: lane l holds points 2 l and 2 l + 1."""
        i0 = base + 2 * LANES
        c0 = np.where(i0 < N, pack(keys[0::2], i0), NONE)
        c1 = np.where(i0 + 1 < N, pack(keys[1::2], i0 + 1), NONE)

        def passing():
            thr = np.uint64(self.thr)
            return ((c0 >> np.uint64(32)) < thr) & (c0 != NONE), (
                (c1 >> np.uint64(32)) < thr) & (c1 != NONE)
        p0, p1 = passing()
        n = int(p0.sum() + p1.sum())
        if n == 0:
            return
        if self.cnt + n > PENDING:
            if self.cnt:
                self.flush()
                q0, q1 = passing()
                p0, p1 = p0 & q0, p1 & q1
                n = int(p0.sum() + p1.sum())
                if n == 0:
                    return
            if n > PENDING:
                self.merge(np.where(p0, c0, NONE), np.where(p1, c1, NONE),
                           True)
                return
        batch = np.concatenate([c0[p0], c1[p1]])
        if self.order is not None:
            batch = self.order.permutation(batch)
        self.pend[self.cnt:self.cnt + n] = batch
        self.cnt += n

    def result(self) -> np.ndarray:
        if self.cnt:
            self.flush()
        entries = np.concatenate([self.e0, self.e1])[:self.k]
        return (entries & np.uint64(0xFFFFFFFF)).astype(np.int64)


def walk(d: np.ndarray, k: int, order=None) -> tuple:
    """The kernel's walk of one query's float32 distances: (indices, the
    number of merges)."""
    N = len(d)
    query = Query(k, order)
    keys = order_key(d)
    for base in range(0, N, ROWS):
        tile = np.full(ROWS, 0xFFFFFFFF, np.uint32)
        tile[:min(ROWS, N - base)] = keys[base:base + ROWS]
        if base:
            query.take(tile, base, N)
        else:
            query.first(tile, N)
    return query.result(), query.merges


def distances(kind: str, N: int, C: int, seed: int) -> np.ndarray:
    """Float32 squared distances of 3 queries to N points (square_distance's
    order), from the kNN checks' seeded clouds."""
    x = torch.from_numpy(knn_cloud(kind, 1, N, seed, C))
    return kk.square_distance(x[:, :3], x)[0].numpy()


@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_selection_walk_gives_the_stable_argsort(kind, k):
    for N in (k, 1000, 2048 + 5):
        if kind == "duplicates" and N < 64:
            continue            # its clouds resample a third of N points
        d = distances(kind, N, 8, N + k)
        for row, order in zip(d, (None, np.random.RandomState(k), None)):
            got, merges = walk(row, k, order)
            want = np.argsort(row, kind="stable")[:k]
            np.testing.assert_array_equal(got, want)
            assert merges >= 1


def test_selection_walk_takes_all_way_ties_and_small_clouds():
    """Every point equal (a tie of all N): indices 0 .. k-1; N = k below
    one tile; the list of 64 filled by one tile."""
    for N, k in ((200, 48), (20, 20), (64, 64), (7, 1)):
        got, _ = walk(np.full(N, 0.37, np.float32), k)
        np.testing.assert_array_equal(got, np.arange(k))


def test_selection_merges_in_batches():
    """On random distances the walk merges a few batches a query, not one
    insertion a candidate (about k ln(N / 64) = 69 at k = 20, N = 2048)."""
    d = distances("random", 2048, 64, 0)
    merges = [walk(row, 20)[1] for row in d]
    assert max(merges) <= 8, merges


# ---- (b) the plan ---------------------------------------------------------

def test_plan_follows_the_new_layout():
    """Shared bytes: keys 18,432, norms 512, pending buffers and counts
    16,640, and the staged rows; DGCNN's C = 64 float32 and C = 128 bf16 at
    one stage, C = 128 float32 at 64-channel stages, all two blocks an
    SM."""
    fixed = 64 * 72 * 4 + 2 * 64 * 4 + 64 * (32 * 8 + 4)
    assert fixed == 35584
    assert kk.channel_smem(64, 64) == fixed + 3 * 64 * 68 * 4 == 87808
    assert kk.channel_smem(128, 128, True) == fixed + 3 * 64 * 136 * 2
    assert kk.channel_smem(128, 64) == fixed + 4 * 64 * 68 * 4 == 105216
    for C, bf16, width in ((64, False, 64), (80, False, 80), (96, False, 96),
                           (100, False, 64), (128, False, 64),
                           (64, True, 64), (128, True, 128),
                           (192, True, 192), (208, True, 64), (3, False, 3)):
        how = kk.plan(2048, 20, C=C, bf16=bf16, tier=kk.CHANNELS)
        assert how.points == width and how.smem <= kk.CH_TWO_BLOCKS
        assert how.warps == kk.CH_WARPS == 8
    # strides: padded to the k-step, an odd number of 16-byte groups
    # (bf16: pairs), 8 rows on 8 different 4-bank groups
    assert [kk.channel_stride(w) for w in (1, 8, 9, 64, 96, 128)] == [
        12, 12, 20, 68, 100, 132]
    assert [kk.channel_stride(w, True) for w in (1, 16, 17, 64, 128)] == [
        24, 24, 40, 72, 136]
    for w in range(1, 300):
        for bf16 in (False, True):
            s = kk.channel_stride(w, bf16)
            words = s // 2 if bf16 else s
            assert s >= w and words % 8 == 4
            assert len({(words * r) % 32 // 4 for r in range(8)}) == 8
