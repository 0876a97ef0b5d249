"""Packing: network weights -> SIMD slot diagonals.

Counterpart of `orion_tpu/compiler/packing.py`: the same code, built on the
multiplexed address map `mux_slots`, from which the convolution matrix, the
linear matrix, biases and BatchNorm vectors follow by index arithmetic.

  A gap-g tensor of logical shape (C, H, W) lives in an FHE grid
  (Cm, Hm, Wm): logical channel c splits into a stored channel c // g^2 and
  a sub-pixel (dy, dx) = divmod(c % g^2, g); logical pixel (y, x) occupies
  stored pixel (y*g + dy, x*g + dx).  Strided convolutions multiply the gap
  by the stride instead of shrinking the image ("multiplexed packing").

Layout conventions:
  * row-major flattening of the FHE grid (Cm, Hm, Wm);
  * a batch of N examples occupies N consecutive copies of the grid;
  * diagonal d of an (h x slots) block B satisfies
      (B v)[j] = sum_d diag_d[j] * v[(j + d) % slots],  j < slots,
    rows replicated period-h when h < slots (hybrid embedding).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp


# ------------------------------------------------------------------ #
#  The multiplexed address map                                       #
# ------------------------------------------------------------------ #

def mux_slots(c, y, x, gap: int, grid) -> np.ndarray:
    """Flat FHE-grid positions of logical elements (c, y, x).

    `grid` is the stored shape (Cm, Hm, Wm); inputs broadcast together.
    Entries whose stored pixel falls outside the grid get -1 (callers use
    this to drop out-of-bounds taps, i.e. zero padding).
    """
    Cm, Hm, Wm = grid
    g2 = gap * gap
    cm, sub = np.divmod(np.asarray(c), g2)
    dy, dx = np.divmod(sub, gap)
    ys = np.asarray(y) * gap + dy
    xs = np.asarray(x) * gap + dx
    flat = (cm * Hm + ys) * Wm + xs
    ok = (ys >= 0) & (ys < Hm) & (xs >= 0) & (xs < Wm) & (cm < Cm)
    return np.where(ok, flat, -1)


def embed_mux(values: np.ndarray, gap: int, grid) -> np.ndarray:
    """Scatter a logical (C, H, W) array into its flat FHE grid vector."""
    C, H, W = values.shape
    c, y, x = np.indices((C, H, W))
    pos = mux_slots(c, y, x, gap, grid)
    out = np.zeros(int(np.prod(grid)))
    keep = pos >= 0
    out[pos[keep]] = values[keep]
    return out


def _batched(matrix: sp.spmatrix, batch: int) -> sp.csr_matrix:
    """A batch of examples = a block-diagonal stack of the same transform."""
    if batch == 1:
        return matrix.tocsr()
    return sp.block_diag([matrix] * batch, format="csr")


# ------------------------------------------------------------------ #
#  Conv2d -> sparse matrix                                           #
# ------------------------------------------------------------------ #

def grouped_weight(layer) -> np.ndarray:
    """Full-channel weight of a grouped conv: each group's kernel sees only
    its own input-channel band; everything else is an exact zero."""
    co, ci_g, kh, kw = layer.on_weight.shape
    full = np.zeros((co, layer.in_channels, kh, kw))
    co_per = co // layer.groups
    for g in range(layer.groups):
        rows = slice(g * co_per, (g + 1) * co_per)
        cols = slice(g * ci_g, (g + 1) * ci_g)
        full[rows, cols] = layer.on_weight[rows]
    return full


def conv_matrix(layer, weight: np.ndarray) -> sp.csr_matrix:
    """Sparse matrix applying `layer` to a flat multiplexed input grid.

    Derivation: enumerate the kernel's nonzero taps (co, ci, ky, kx) once,
    broadcast them against the logical output positions (yo, xo), map both
    ends through `mux_slots`, and scatter the surviving triplets.  Stride
    never appears explicitly: output_gap = input_gap * stride, so stepping
    one multiplexed output pixel advances the input anchor by exactly
    stride input pixels.
    """
    batch = layer.fhe_input_shape[0]
    in_grid = layer.fhe_input_shape[1:]
    out_grid = layer.fhe_output_shape[1:]
    Ho, Wo = layer.output_shape[2:]
    P, D = layer.padding[0], layer.dilation[0]
    iG, oG = layer.input_gap, layer.output_gap
    s = oG // iG  # stride, recovered from the gap relation

    co, ci, ky, kx = (a[:, None, None] for a in np.nonzero(weight))
    w = weight[np.nonzero(weight)][:, None, None]
    yo = np.arange(Ho)[None, :, None]
    xo = np.arange(Wo)[None, None, :]

    rows = mux_slots(co, yo, xo, oG, out_grid)
    # logical input pixel of this tap; mux_slots(-1 handling) drops the
    # taps that fall into the zero padding
    yi = yo * s - P + ky * D
    xi = xo * s - P + kx * D
    cols = mux_slots(ci, yi, xi, iG, in_grid)

    keep = (rows >= 0) & (cols >= 0)
    mat = sp.coo_matrix(
        (np.broadcast_to(w, rows.shape)[keep],
         (rows[keep], cols[keep])),
        shape=(int(np.prod(out_grid)), int(np.prod(in_grid))))
    return _batched(mat, batch)


def construct_conv2d_bias(layer) -> np.ndarray:
    batch, Co, Ho, Wo = layer.output_shape
    per_elem = np.broadcast_to(
        np.asarray(layer.on_bias, np.float64).reshape(Co, 1, 1),
        (Co, Ho, Wo))
    vec = embed_mux(per_elem, layer.output_gap, layer.fhe_output_shape[1:])
    return np.tile(vec, batch)


# ------------------------------------------------------------------ #
#  Linear -> sparse matrix                                           #
# ------------------------------------------------------------------ #

def linear_matrix(layer) -> sp.csr_matrix:
    """Dense weight as a sparse matrix over the (possibly multiplexed)
    input grid.  After a Flatten of a spatial tensor, weight column
    (ci, y, x) must be read from that element's multiplexed slot."""
    if len(layer.input_shape) == 2:
        batch = layer.input_shape[0]
        mat = sp.csr_matrix(np.asarray(layer.on_weight, np.float64))
    else:
        batch, Ci, Hi, Wi = layer.input_shape
        grid = layer.fhe_input_shape[1:]
        c, y, x = np.indices((Ci, Hi, Wi))
        pos = mux_slots(c, y, x, layer.input_gap, grid).reshape(-1)
        w = np.asarray(layer.on_weight, np.float64)  # (out, Ci*Hi*Wi)
        out_idx = np.repeat(np.arange(w.shape[0]), pos.size)
        col_idx = np.tile(pos, w.shape[0])
        vals = w.reshape(-1)
        keep = (col_idx >= 0) & (vals != 0)
        mat = sp.coo_matrix(
            (vals[keep], (out_idx[keep], col_idx[keep])),
            shape=(w.shape[0], int(np.prod(grid))))
    return _batched(mat, batch)


def construct_linear_bias(layer) -> np.ndarray:
    batch = layer.input_shape[0]
    return np.tile(np.asarray(layer.on_bias, dtype=np.float64), batch)


# ------------------------------------------------------------------ #
#  Generalised-diagonal extraction                                   #
# ------------------------------------------------------------------ #

def extract_diagonals(matrix: sp.spmatrix, slots: int, embed_method: str,
                      is_last_layer: bool):
    """Slice a sparse matrix into (slots x slots) blocks of generalised
    diagonals, straight from the COO triplets.

    Returns ({(block_row, block_col): {d: vec}}, output_rotations).

    Diagonal layout, one formula for both embeddings: diagonal indices
    range over [0, height); entry (rr, cc) of a block sits on diagonal
    d = (cc - rr) mod height at position j = (cc - d) mod slots.  Row rr is
    thereby replicated every `height` positions, each replica j covering
    the column window [j, j+height) — so for height == slots the replica is
    unique and d is the classic generalised diagonal, while for the hybrid
    embedding (single short block row, height = 2^ceil(log2(rows))) the
    caller sums the window partials with log2(slots/height) rotations.
    The last layer stays square so replicated partials never reach the
    user's decrypted output.
    """
    mh, mw = matrix.shape
    n_brow = math.ceil(mh / slots)
    n_bcol = math.ceil(mw / slots)

    hybrid = (n_brow == 1 and embed_method == "hybrid"
              and not is_last_layer)
    height = 1 << max(0, (mh - 1)).bit_length() if hybrid else slots
    out_rots = int(math.log2(slots // height)) if hybrid else 0

    coo = matrix.tocoo()
    coo.sum_duplicates()
    coo.eliminate_zeros()
    br, rr = np.divmod(coo.row, height)
    bc, cc = np.divmod(coo.col, slots)
    d = (cc - rr) % height
    j = (cc - d) % slots

    blocks: dict[tuple, dict[int, np.ndarray]] = {
        (i, jj): {} for i in range(n_brow) for jj in range(n_bcol)}
    group = (br * n_bcol + bc) * height + d
    order = np.argsort(group, kind="stable")
    cuts = np.flatnonzero(np.diff(group[order])) + 1
    for sel in np.split(order, cuts):
        if sel.size == 0:
            continue
        key = (int(br[sel[0]]), int(bc[sel[0]]))
        vec = np.zeros(slots)
        vec[j[sel]] = coo.data[sel]
        blocks[key][int(d[sel[0]])] = vec
    for key, diags in blocks.items():
        if not diags:
            diags[0] = np.zeros(slots)
    return blocks, out_rots


# ------------------------------------------------------------------ #
#  Layer-level entry points                                          #
# ------------------------------------------------------------------ #

def pack_linear(layer, last: bool):
    return extract_diagonals(
        linear_matrix(layer), layer.scheme.params.slots,
        layer.scheme.params.embedding_method, last)


def pack_conv2d(layer, last: bool):
    weight = (grouped_weight(layer) if layer.groups > 1
              else np.asarray(layer.on_weight, np.float64))
    return extract_diagonals(
        conv_matrix(layer, weight), layer.scheme.params.slots,
        layer.scheme.params.embedding_method, last)


# ------------------------------------------------------------------ #
#  BatchNorm packing                                                 #
# ------------------------------------------------------------------ #

def pack_bn1d(bn):
    batch = bn.input_shape[0]
    mean = np.tile(np.asarray(bn.on_running_mean, np.float64).ravel(), batch)
    inv_std = np.tile(1.0 / np.sqrt(bn.on_running_var + bn.eps), batch)
    weight = bias = None
    if bn.affine:
        weight = np.tile(np.asarray(bn.on_weight, np.float64).ravel(), batch)
        bias = np.tile(np.asarray(bn.on_bias, np.float64).ravel(), batch)
    return mean, inv_std, weight, bias


def pack_bn2d(bn):
    """Per-channel statistics embedded at the multiplexed slots.

    Slots outside the logical tensor get inv_std = 0, which additionally
    ZEROES any partial-sum garbage the preceding transform left in gap
    slots, as orion_tpu does (upstream Orion leaves 1/sqrt(eps) there)."""
    batch, Ci, Hi, Wi = bn.input_shape
    grid = bn.fhe_input_shape[1:]

    def spread(per_channel):
        arr = np.broadcast_to(
            np.asarray(per_channel, np.float64).reshape(Ci, 1, 1),
            (Ci, Hi, Wi))
        return np.tile(embed_mux(arr, bn.input_gap, grid), batch)

    mean = spread(bn.on_running_mean)
    inv_std = spread(1.0 / np.sqrt(bn.on_running_var + bn.eps))
    weight = bias = None
    if bn.affine:
        weight = spread(bn.on_weight)
        bias = spread(bn.on_bias)
    return mean, inv_std, weight, bias
