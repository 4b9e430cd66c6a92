"""What kernels B6/B7's body (``csrc/fastfood.cu``) rests on, on the CPU.

The card is the only place the body runs, so its index arithmetic is
copied here in numpy and run on seeded operators: a warp's registers as a
(32 lanes, E values) array, the row's slot of the cos tile as a flat array
of padded places. The copy must reproduce ``kernels/fwht/ref.py``'s
``fastfood_project`` (float64, to 1e-9 relative: only the order of the
butterfly stages differs), every warp-wide shared-memory access of the
transposes, the cos writes and the readout's fragment loads must hit 32
distinct banks (a conflict count of 0; the permutation's gather reads
where the permutation says), and the fragment placement of the readout's
m16n8k8 products must give the cos tile times the readout slice.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fwht import kernel as ff  # noqa: E402
from repro_torch.kernels.fwht.ref import fastfood_project  # noqa: E402

TILE_ROWS, HEADS = 16, 16
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into on an H100
TF32_BITS = np.uint32(0xFFFFE000)  # sign, exponent and 10 mantissa bits
LANES = np.arange(32)


def geo(dd):
    """``Geo<DD>`` of fastfood.cu."""
    L = min(dd, 32)
    e = dd // L
    warps = dd // 2 if dd <= 16 else 16 if dd <= 1024 else 8
    shift = e.bit_length() - 1 if e > 32 else 5
    kp = max(dd, 8)
    row_len = kp + ((kp - 1) >> shift)
    stride = row_len + (12 - row_len % 8) % 8
    g = SimpleNamespace(L=L, rw=32 // L, e=e, warps=warps, shift=shift, kp=kp)
    g.row_len, g.stride = row_len, stride
    g.passes = TILE_ROWS // (warps * g.rw)
    def whole(words):  # a segment rounded up to 16 bytes
        return -(-words // 4) * 4

    g.segments = [0, whole(dd)]  # B, (G, place) pairs, (S, phase) pairs, cos tile
    g.segments += [g.segments[-1] + whole(2 * dd)]
    g.segments += [g.segments[-1] + whole(2 * row_len)]
    ws_at = g.segments[-1] + TILE_ROWS * stride + warps * TILE_ROWS * HEADS
    g.segments += [ws_at - warps * TILE_ROWS * HEADS, ws_at]  # partial tiles, slice
    slice_words = dd + 4 if 64 <= dd <= 1024 else 0  # a row of the f32 slice
    g.bytes = lambda k: 4 * (ws_at + min(k, HEADS) * slice_words)
    return g


def pad(g, i):
    return i + (i >> g.shift)


def conflicts(addrs) -> int:
    """Extra shared-memory wavefronts of one warp-wide 4-byte access: the
    most distinct words that fall in one bank, less one."""
    words = np.unique(np.asarray(addrs).ravel())
    return int(np.bincount(words % 32, minlength=32).max()) - 1


def reg_stages(v, n):
    """Butterflies over register bits: pairs (j, j | s), s = 1 .. n/2."""
    s = 1
    while s < n:
        for j in range(v.shape[1]):
            if j & s == 0:
                a, b = v[:, j].copy(), v[:, j | s].copy()
                v[:, j], v[:, j | s] = a + b, a - b
        s <<= 1


def shfl_stage(v, h):
    """One butterfly with the lane h away (lanes on axis 0)."""
    lanes = np.arange(v.shape[0])
    partner = v[lanes ^ h]
    hi = ((lanes & h) != 0).reshape((-1,) + (1,) * (v.ndim - 1))
    return np.where(hi, partner - v, v + partner)


class Body:
    """fastfood.cu's row and readout arithmetic for one stack, d' = ``dd``;
    ``seen`` collects the conflict count of every shared-memory access
    that must be conflict-free."""

    def __init__(self, dd, B, G, perm, S, phase):
        self.g, self.dd = geo(dd), dd
        self.B, self.G, self.S, self.phase = B, G, S, phase
        self.pidx = pad(self.g, perm.astype(np.int64))
        self.seen = []

    def access(self, addrs):
        self.seen.append(conflicts(addrs))
        assert addrs.max() < self.g.row_len  # inside the row's slot
        return addrs

    def row_wide(self, z, slot):
        """``row_wide``: one row of d' >= 64 into ``slot`` (its padded
        places); returns the projection, element order."""
        g, e = self.g, self.g.e
        slot[: z.size] = z  # Z's row as stage_z copies it: element i at i
        v = np.empty((32, e))
        for j in range(e):
            i = 32 * j + LANES
            v[:, j] = np.where(i < z.size, slot[self.access(i)], 0.0) * self.B[i]

        def transform_tail(v):
            for j in range(e):  # store_a
                slot[self.access(pad(g, 32 * j + LANES))] = v[:, j]
            for j in range(e):  # load_b
                v[:, j] = slot[self.access(pad(g, e * LANES + j))]
            reg_stages(v, min(e, 32))
            h = 1
            while h * e < 32:
                v = shfl_stage(v, h)
                h <<= 1
            return v

        reg_stages(v, e)
        v = transform_tail(v)
        for j in range(e):  # store_b, then the gather back to layout A
            slot[self.access(pad(g, e * LANES + j))] = v[:, j]
        for j in range(e):
            i = 32 * j + LANES
            v[:, j] = slot[self.pidx[i]] * self.G[i]
        reg_stages(v, e)
        v = transform_tail(v)
        for j in range(e):  # store_b; the cos reads the row back
            slot[self.access(pad(g, e * LANES + j))] = v[:, j]
        proj = np.empty(self.dd)
        for j in range(e):
            i = e * LANES + j
            proj[i] = slot[self.access(pad(g, i))] * self.S[i]
            slot[self.access(pad(g, i))] = np.cos(proj[i] + self.phase[i])
        return proj

    def rows_narrow(self, zs, slots):
        """``row_narrow``: the warp's RW rows of d' <= 32 (lane = rl L + l)
        into their slots; returns their projections."""
        g, dd = self.g, self.dd
        lane = np.arange(32)
        l, rl = lane % g.L, lane // g.L
        for r in range(g.rw):  # Z's rows as stage_z copies them
            slots[r][: zs[r].size] = zs[r]
        x = np.array([slots[r][i] if i < zs[r].size else 0.0 for r, i in zip(rl, l)])
        x = x * self.B[l]
        h = 1
        while h < g.L:
            x = shfl_stage(x, h)
            h <<= 1
        for r in range(g.rw):
            slots[r][l[rl == r]] = x[rl == r]
        x = np.array([slots[r][self.pidx[i]] for r, i in zip(rl, l)]) * self.G[l]
        h = 1
        while h < g.L:
            x = shfl_stage(x, h)
            h <<= 1
        proj = x * self.S[l]
        for r in range(g.rw):
            slots[r][l[rl == r]] = np.cos(proj + self.phase[l])[rl == r]
        return proj.reshape(g.rw, dd)

    def tile(self, Zt):
        """The 16-row cos tile of rows ``Zt`` (zero rows past them), as the
        warps fill it; returns (flat tile, projections of Zt's rows)."""
        g = self.g
        ct = np.full(TILE_ROWS * g.stride, np.nan)
        for r in range(TILE_ROWS):  # the k padding past d' (d' < 8)
            ct[r * g.stride + self.dd : r * g.stride + g.kp] = 0.0
        rows = [Zt[r] if r < len(Zt) else np.zeros(0) for r in range(TILE_ROWS)]
        proj = np.empty((TILE_ROWS, self.dd))
        for p in range(g.passes):
            for w in range(g.warps):
                first = (p * g.warps + w) * g.rw
                views = [ct[(first + r) * g.stride :][: g.stride] for r in range(g.rw)]
                if self.dd <= 32:
                    mine = rows[first : first + g.rw]
                    proj[first : first + g.rw] = self.rows_narrow(mine, views)
                else:
                    proj[first] = self.row_wide(rows[first], views[0])
        return ct, proj[: len(Zt)]

    def readout(self, ct, wt, kh):
        """``readout`` and the partials' sum: each warp's fragment loads, its
        m16n8k8 products (A (16 x 8) times B (8 x 8), placed in the lanes'
        fragments as the PTX ISA lays them out), the lanes' accumulators
        written to the warp's partial tile, the partials added in warp
        order: (16 rows, 16 heads)."""
        g, dd = self.g, self.dd
        steps = g.kp // 8
        per = -(-steps // g.warps)
        gq, t = LANES // 4, LANES % 4
        red = np.zeros((g.warps, TILE_ROWS * HEADS))
        for w in range(g.warps):
            acc = np.zeros((2, 4, 32))  # (n-tile, fragment register, lane)
            for kk in range(w * per, min(steps, w * per + per)):
                c = 8 * kk + t
                A = np.zeros((16, 8))
                for rows, cols in ((gq, c), (gq + 8, c), (gq, c + 4), (gq + 8, c + 4)):
                    addrs = rows * g.stride + pad(g, cols)
                    self.seen.append(conflicts(addrs))
                    A[rows, cols - 8 * kk] = ct[addrs]
                for nt in range(2):
                    live = 8 * nt + gq < kh
                    Bf = np.zeros((8, 8))  # (k, n): b0 at (t, g), b1 at (t + 4, g)
                    for k in (c, c + 4):
                        if 64 <= dd <= 1024 and live.any():  # the slice's copy
                            h, kl = (8 * nt + gq)[live], k[live]  # live heads only
                            f32_words = h * (dd + 4) + kl
                            int8_words = (h * (dd + 16) + kl) // 4
                            self.seen += [conflicts(f32_words), conflicts(int8_words)]
                        w_k = wt[8 * nt + gq, k % dd]
                        Bf[k - 8 * kk, gq] = np.where(live & (k < dd), w_k, 0)
                    C = A @ Bf
                    # c0 .. c3: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
                    c_frag = [C[r, 2 * t + u] for r in (gq, gq + 8) for u in (0, 1)]
                    acc[nt] += np.stack(c_frag)
            for nt in range(2):
                col = 8 * nt + 2 * t
                red[w, gq * HEADS + col] = acc[nt, 0]
                red[w, gq * HEADS + col + 1] = acc[nt, 1]
                red[w, (gq + 8) * HEADS + col] = acc[nt, 2]
                red[w, (gq + 8) * HEADS + col + 1] = acc[nt, 3]
        total = np.zeros(TILE_ROWS * HEADS)
        for w in range(g.warps):
            total = total + red[w]
        return total.reshape(TILE_ROWS, HEADS)


def _operators(dd, stacks, seed):
    rng = np.random.default_rng(seed)
    B = rng.choice([-1.0, 1.0], (stacks, dd))
    G = rng.standard_normal((stacks, dd))
    perm = np.stack([rng.permutation(dd) for _ in range(stacks)])
    S = rng.uniform(0.5, 1.5, (stacks, dd)) / dd
    phase = rng.uniform(0, 2 * np.pi, (stacks, dd))
    return B, G, perm, S, phase


@pytest.mark.parametrize(
    "dd,d,n", [(4, 3, 20), (32, 20, 17), (1024, 780, 3), (2048, 1500, 2)]
)
def test_body_index_arithmetic_reproduces_fastfood_project(dd, d, n):
    """In-register stages, the padded transposes, the gather merged with
    the transpose back, and the cos tile's padded rows: the projection of
    every row is the plain one's, and every access that should be is
    conflict-free."""
    stacks = 2
    B, G, perm, S, phase = _operators(dd, stacks, seed=dd)
    Z = np.random.default_rng(d).standard_normal((n, d))
    want = fastfood_project(*(torch.from_numpy(a) for a in (Z, B, G, perm, S))).numpy()
    for s in range(stacks):
        body = Body(dd, B[s], G[s], perm[s], S[s], phase[s])
        tiles = [body.tile(Z[t0 : t0 + TILE_ROWS])[1] for t0 in range(0, n, TILE_ROWS)]
        mine = want[:, s * dd : (s + 1) * dd]
        np.testing.assert_allclose(np.concatenate(tiles), mine, rtol=1e-9, atol=1e-12)
        if dd >= 64:  # a row: Z, 3 stores, 2 loads, the cos's load and store; E each
            assert len(body.seen) == 9 * geo(dd).e * TILE_ROWS * -(-n // TILE_ROWS)
        assert sum(body.seen) == 0


@pytest.mark.parametrize("dd", [4, 32, 1024, 2048])
def test_readout_fragments_give_the_cos_tile_times_the_slice(dd):
    """The warps' fragment loads (conflict-free), the m16n8k8 placement and
    the warp-order sum give cos(proj + phase) @ wt_slice.T for the tile's
    rows, heads past K reading zeros."""
    B, G, perm, S, phase = _operators(dd, 1, seed=dd + 1)
    body = Body(dd, B[0], G[0], perm[0], S[0], phase[0])
    rng = np.random.default_rng(dd)
    Z = rng.standard_normal((TILE_ROWS, min(dd, 780)))
    ct, proj = body.tile(Z)
    k = 10
    wt = rng.standard_normal((HEADS, dd))
    body.seen.clear()
    got = body.readout(ct, wt, k)
    assert sum(body.seen) == 0
    want = np.zeros((TILE_ROWS, HEADS))
    want[:, :k] = np.cos(proj + phase[0]) @ wt[:k].T
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dd", [2 << i for i in range(11)])
def test_every_instantiation_fits_and_tiles_sixteen_rows(dd):
    g = geo(dd)
    assert g.passes * g.warps * g.rw == TILE_ROWS
    assert g.stride % 8 == 4 and g.stride >= g.row_len >= g.kp
    assert all(at % 4 == 0 for at in g.segments)  # 16-byte aligned (cp.async, float2)
    assert g.bytes(HEADS) <= SMEM_LIMIT
    assert pad(g, dd - 1) < g.row_len and pad(g, dd - 1) < 2**15  # int16 places


def _split_tf32(x):
    """ptx::split_tf32: (hi, lo) bit patterns of f32 ``x``."""
    x = np.asarray(x, np.float32)
    hi = (x.view(np.uint32) + np.uint32(0x1000)) & TF32_BITS
    lo = (x - hi.view(np.float32)).view(np.uint32) + np.uint32(0x1000)
    return hi, lo


def test_tf32_split_of_cos_values_is_exact_to_f32_rounding():
    """B6's readout splits each cos value c into hi + lo: in f32 the two
    terms add back to c exactly, and the TF32 bits the MMA reads of lo
    leave at most half a TF32 step of lo, under 2^-21 |c|."""
    c = np.cos(np.random.default_rng(0).uniform(-50, 50, 200_000)).astype(np.float32)
    hi, lo = _split_tf32(c)
    lo_f32 = (lo - np.uint32(0x1000)).view(np.float32)
    np.testing.assert_array_equal(hi.view(np.float32) + lo_f32, c)
    lo_tf32 = (lo & TF32_BITS).view(np.float32)
    pair = hi.view(np.float32).astype(np.float64) + lo_tf32.astype(np.float64)
    err = np.abs(c - pair)
    assert (err <= 2.0**-21 * np.abs(c)).all()


def test_int8_readout_values_are_exact_in_tf32():
    """B7 feeds the int8 readout's values to the MMA unsplit: every int8
    value is a float with no bits below TF32's."""
    w = np.arange(-128, 128, dtype=np.int8).astype(np.float32)
    assert ((w.view(np.uint32) & ~TF32_BITS) == 0).all()
    hi, lo = _split_tf32(w)
    np.testing.assert_array_equal(hi.view(np.float32), w)
    assert not (lo & TF32_BITS).any()


@pytest.mark.parametrize("stacks,k", [(1, 10), (4, 10), (2, 17), (16, 3)])
def test_block_rows_are_whole_tiles_that_spread_the_rows_best(stacks, k):
    """The wrapper's rows a block: a multiple of 16 (so any named block_n,
    1 and 32 included, maps to a tile the kernels run), no more than asked
    (rounded up to a tile), and of those the one that leaves an SM the
    fewest rows at one block an SM, the largest of equals."""
    groups = -(-k // HEADS)

    def rows_an_sm(bn, n):
        return -(-(-(-n // bn) * stacks * groups) // ff.SMS) * bn

    for block_n in (1, 8, 16, 32, 64, 100, 256, 1000):
        top = max(TILE_ROWS, -(-block_n // TILE_ROWS) * TILE_ROWS)
        for n in (1, 32, 300, 1024, 8192):
            bn = ff.block_rows(block_n, n, stacks, k)
            assert bn % TILE_ROWS == 0 and TILE_ROWS <= bn <= top
            least = min(rows_an_sm(b, n) for b in range(TILE_ROWS, top + 1, TILE_ROWS))
            assert rows_an_sm(bn, n) == least
            larger = range(bn + TILE_ROWS, top + 1, TILE_ROWS)
            assert all(rows_an_sm(b, n) > least for b in larger)


def test_block_rows_at_the_smoke_shapes():
    """n=1024, K=10, the default tile: at F=4096 (4 stacks of 1024) 32 rows,
    128 blocks in one wave; at F=1024 (one stack) 16 rows, 64 blocks, one a
    16-row tile, the most any tile of whole m16 fragments gives (132 would
    need 8 rows a block); at n=32 16 rows."""
    default = ff.tuning.lookup("fwht").block_n
    assert ff.block_rows(default, 1024, 4, 10) == 32
    assert ff.block_rows(default, 1024, 1, 10) == TILE_ROWS
    assert ff.block_rows(default, 32, 4, 10) == TILE_ROWS
    assert ff.tuning.lookup("fwht_q8") == ff.tuning.lookup("fwht")
