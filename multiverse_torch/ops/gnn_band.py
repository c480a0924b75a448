"""The band layout of the training attention launches
(``csrc/gnn_dense.cu``, K4 and K5), for the CPU tests.

A block owns a band of one image row y by BW columns of one sample (BW
the width rounded up to 16, at most 64) and stages rows y - 1 .. y + 1,
columns c0 - 1 .. c0 + BW: slot ``dy * (BW + 2) + (x - c0 + 1)`` holds
pixel (y + dy - 1, x), zero off the grid. Warp t owns the tile of 16
pixels (y, x0 + i), x0 = c0 + 16 t; its 64 candidates are c = 18 dy +
dx, pixel (y + dy - 1, x0 + dx - 1) for dy < 3, dx < 18, and 54..63 are
padding. Pixel i's neighbour j = 3 dy + dx (dy, dx < 3) is candidate
18 dy + i + dx, and that neighbour sees the pixel as its neighbour 8 - j.

The launches compute these indices themselves: nothing on the path
calls this module. It mirrors them so that the tests can pin the index
arithmetic where there is no GPU.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

TILE = 16          # pixels of one image row a warp
CAND_COLS = 18     # candidate columns x0 - 1 .. x0 + 16
LIVE_CANDS = 54    # 3 rows x 18 columns
CANDS = 64         # padded to eight n8 tiles


def band_width(W: int) -> int:
    """BW: the grid width rounded up to 16, at most 64."""
    return min(64, -(-W // TILE) * TILE)


def neighbour_candidates(i: int) -> list:
    """The candidates of tile pixel i's nine neighbours, in (dy, dx)
    order j = 3 dy + dx."""
    return [CAND_COLS * (j // 3) + i + j % 3 for j in range(9)]


class Tile(NamedTuple):
    c0: int            # the band's first column
    warp: int          # the tile within the band
    y: int             # the tile's image row and first column
    x0: int
    npix: int          # pixels of the tile inside the grid (0: none)


def tiles(H: int, W: int) -> Iterator[Tile]:
    """Every warp's tile of one sample, band by band in launch order
    (columns fastest), warps in order within a band."""
    BW = band_width(W)
    for y in range(H):
        for c0 in range(0, W, BW):
            for warp in range(BW // TILE):
                x0 = c0 + TILE * warp
                yield Tile(c0, warp, y, x0, min(TILE, W - x0) if x0 < W
                           else 0)


def staged_pixels(H: int, W: int, tile: Tile) -> torch.Tensor:
    """[3 * (BW + 2)] the pixel (y * W + x) each slot of the tile's band
    stages, -1 off the grid."""
    SW = band_width(W) + 2
    slot = torch.arange(3 * SW)
    y, x = tile.y - 1 + slot // SW, tile.c0 - 1 + slot % SW
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    return torch.where(inside, y * W + x, torch.full_like(slot, -1))


def candidate_slots(tile: Tile, W: int) -> torch.Tensor:
    """[64] the staged slot of each candidate of the tile; padding reads
    slot 0 (its weights are 0)."""
    c = torch.arange(CANDS)
    slot = c // CAND_COLS * (band_width(W) + 2) + TILE * tile.warp \
        + c % CAND_COLS
    return torch.where(c < LIVE_CANDS, slot, torch.zeros_like(c))


def own_slots(tile: Tile, W: int) -> torch.Tensor:
    """[16] the staged slot of each of the tile's own pixels."""
    return band_width(W) + 2 + TILE * tile.warp + 1 + torch.arange(TILE)


def live_candidates(H: int, W: int, tile: Tile) -> torch.Tensor:
    """[16, 64] bool: candidate c is one of tile pixel i's in-grid
    neighbours (and pixel i is in the grid)."""
    i = torch.arange(TILE)[:, None]
    c = torch.arange(CANDS)[None, :]
    dy, dx = c // CAND_COLS, c % CAND_COLS - i
    y, x = tile.y + dy - 1, tile.x0 + i + dx - 1
    return ((i < tile.npix) & (c < LIVE_CANDS) & (dx >= 0) & (dx < 3)
            & (y >= 0) & (y < H) & (x >= 0) & (x < W))
