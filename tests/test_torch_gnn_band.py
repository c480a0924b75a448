"""The band layout of K4 and K5 (``ops/gnn_band.py``) on the CPU.

The launches of ``csrc/gnn_dense.cu`` stage a band of image rows per
block (an image row and its halo) and multiply each warp's tile of 16
pixels against 64 candidates.
Here a plain-torch emulation of both launches' products, through the
same index map (staged slots, candidates, each pixel's nine positions,
the [N*HW, 9] scratch between K5's two launches), must equal the plain
versions ``gnn_dense_fwd_ref`` / ``gnn_dense_bwd_ref`` in f64, on the
shapes of the card tests: every edge of the band (W = 16, W not a
multiple of 16, W above one band of 64 columns, H = 1 and 2, N = 1,
widths not a multiple of 8).
"""

import pytest
import torch

from multiverse_torch.ops.fused_decode import _neighbor_bias
from multiverse_torch.ops.fused_gnn import gnn_dense_bwd_ref, gnn_dense_fwd_ref
from multiverse_torch.ops.gnn_band import (
    CANDS,
    TILE,
    candidate_slots,
    live_candidates,
    neighbour_candidates,
    own_slots,
    staged_pixels,
    tiles,
)

# (N, H, W, D, C): node width D + C, state width D
SHAPES = [
    (3, 6, 8, 16, 4),          # small; Dn = 20, not a multiple of 8
    (2, 7, 9, 32, 0),          # odd grid, no scene features
    (2, 18, 32, 256, 64),      # the training decode's widths (N cut)
    (2, 9, 16, 32, 8),         # the 9x16 grid of stride 4: W = 16
    (2, 5, 33, 32, 8),         # W = 33: a tile of one pixel
    (3, 1, 8, 16, 4),          # H = 1: both halo rows off the grid
    (2, 2, 9, 16, 4),          # H = 2
    (1, 6, 8, 32, 8),          # N = 1
    (2, 6, 8, 16, 4),          # Dn = 20
    (2, 5, 7, 18, 4),          # Ds = 18, Dn = 22
    (1, 3, 70, 16, 4),         # W = 70: two column bands
]


def _operands(N, H, W, D, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    h = torch.tanh(torch.randn(N * H * W, D, generator=g, dtype=f64))
    node = torch.cat([h, torch.rand(N * H * W, C, generator=g, dtype=f64)],
                     dim=-1)
    node = node / node.norm(dim=-1, keepdim=True)
    return node, h, torch.randn(N * H * W, D, generator=g, dtype=f64)


def _staged(x, pix):
    """A block's staged rows of x (one sample): zero off the grid."""
    out = x.new_zeros(pix.shape[0], x.shape[1])
    out[pix >= 0] = x[pix[pix >= 0]]
    return out


def _softmax(edges, live):
    m = torch.where(live, edges, torch.full_like(edges, -torch.inf))
    m = m.amax(dim=-1, keepdim=True).clamp_min(-1e300)
    e = torch.where(live, torch.exp(edges - m), torch.zeros_like(edges))
    total = e.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, e / total, torch.zeros_like(e))


def _band_tiles(N, H, W):
    """(sample, tile, staged pixels, candidate slots, own slots, live,
    the tile's rows) of every tile with a pixel in the grid."""
    for n in range(N):
        for t in tiles(H, W):
            if not t.npix:
                continue
            rows = t.y * W + t.x0 + torch.arange(t.npix)
            yield (n, t, staged_pixels(H, W, t), candidate_slots(t, W),
                   own_slots(t, W), live_candidates(H, W, t), rows)


def _edges_pass(node, H, W):
    """The f32 (here f64) weights of every tile, as K4 and K5's first
    launch compute them."""
    HW = H * W
    for n, t, pix, cand, own, live, rows in _band_tiles(
            node.shape[0] // HW, H, W):
        sn = _staged(node[n * HW:(n + 1) * HW], pix)
        attn = _softmax(sn[own] @ sn[cand].T, live)
        yield n, t, pix, cand, own, live, rows, attn


def band_fwd(node, states, H, W):
    HW = H * W
    out = torch.full((node.shape[0], states.shape[1]), torch.nan,
                     dtype=node.dtype)
    for n, t, pix, cand, own, live, rows, attn in _edges_pass(node, H, W):
        ss = _staged(states[n * HW:(n + 1) * HW], pix)
        w = attn.to(states.dtype).to(node.dtype)
        out[n * HW + rows] = (w @ ss[cand])[:t.npix]
    return out


def band_bwd(node, states, g, H, W):
    HW = H * W
    N = node.shape[0] // HW
    g_c = g.to(states.dtype).to(node.dtype)
    # launch 1: attn and dedges as [N*HW, 9] scratch, 0 off the grid
    attn_s = torch.full((N * HW, 9), torch.nan, dtype=node.dtype)
    dedges_s = attn_s.clone()
    for n, t, pix, cand, own, live, rows, attn in _edges_pass(node, H, W):
        ss = _staged(states[n * HW:(n + 1) * HW], pix)
        gs = _staged(g_c[n * HW:(n + 1) * HW], pix)
        dattn = gs[own] @ ss[cand].T
        dedges = attn * (dattn - (dattn * attn).sum(dim=-1, keepdim=True))
        for i in range(t.npix):
            pos = neighbour_candidates(i)
            attn_s[n * HW + rows[i]] = attn[i, pos]
            dedges_s[n * HW + rows[i]] = dedges[i, pos]
    # launch 2: the band weights from the scratch, then two products
    dnode = torch.full_like(node, torch.nan)
    dstates = torch.full_like(states, torch.nan)
    for n, t, pix, cand, _, live, rows in _band_tiles(N, H, W):
        wa = torch.zeros(TILE, CANDS, dtype=node.dtype)
        ws = torch.zeros_like(wa)
        for i in range(t.npix):
            b = n * HW + rows[i]
            for j, c in enumerate(neighbour_candidates(i)):
                if live[i, c]:
                    a = n * HW + pix[cand[c]]
                    wa[i, c] = attn_s[a, 8 - j]
                    ws[i, c] = dedges_s[b, j] + dedges_s[a, 8 - j]
        wa = wa.to(states.dtype).to(node.dtype)
        ws = ws.to(node.dtype)
        gs = _staged(g_c[n * HW:(n + 1) * HW], pix)
        sn = _staged(node[n * HW:(n + 1) * HW], pix)
        dstates[n * HW + rows] = (wa @ gs[cand])[:t.npix]
        dnode[n * HW + rows] = (ws @ sn[cand])[:t.npix]
    return dnode, dstates


@pytest.mark.parametrize("N,H,W,D,C", SHAPES)
def test_band_forward_equals_the_plain_version(N, H, W, D, C):
    node, states, _ = _operands(N, H, W, D, C)
    torch.testing.assert_close(band_fwd(node, states, H, W),
                               gnn_dense_fwd_ref(node, states, H, W),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,H,W,D,C", SHAPES)
def test_band_backward_equals_the_plain_version(N, H, W, D, C):
    node, states, g = _operands(N, H, W, D, C, seed=1)
    got = band_bwd(node, states, g, H, W)
    for a, b in zip(got, gnn_dense_bwd_ref(node, states, g, H, W)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,H,W,D,C", SHAPES)
def test_band_map_covers_each_pixel_and_its_neighbourhood_once(
        N, H, W, D, C):
    """Each pixel lies in exactly one tile; its live candidates are the
    staged copies of exactly its in-grid 3x3 neighbours, each once; a
    block stages nothing outside its sample."""
    HW = H * W
    mask = _neighbor_bias(H, W, torch.device("cpu")) == 0
    seen = torch.zeros(HW, dtype=torch.long)
    for _, t, pix, cand, own, live, rows in _band_tiles(1, H, W):
        assert int(pix.max()) < HW and int(pix.min()) >= -1
        assert torch.equal(pix[own[:t.npix]], rows)
        seen[rows] += 1
        for i in range(t.npix):
            nb = pix[cand[live[i]]]
            assert int(nb.min()) >= 0
            assert sorted(nb.tolist()) == \
                torch.nonzero(mask[rows[i]]).flatten().tolist()
        assert not live[t.npix:].any()
    assert torch.equal(seen, torch.ones(HW, dtype=torch.long))


def test_neighbour_positions_are_mirrored():
    """Neighbour j of pixel b sees b as its neighbour 8 - j: the index
    K5's second launch reads the scratch at."""
    H, W = 4, 5
    for y in range(H):
        for x in range(W):
            for j in range(9):
                ya, xa = y + j // 3 - 1, x + j % 3 - 1
                yb, xb = ya + (8 - j) // 3 - 1, xa + (8 - j) % 3 - 1
                assert (yb, xb) == (y, x)
    assert neighbour_candidates(0) == [0, 1, 2, 18, 19, 20, 36, 37, 38]
    assert max(neighbour_candidates(TILE - 1)) == 53
