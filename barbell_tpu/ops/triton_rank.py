"""GPU kernel (Pallas, Triton route): barcode rank pass 1.

For every (window h, pattern p) lane, in one kernel with no device-memory
intermediates:

- the semiglobal edit DP of pattern p over window h (scaled integer
  costs of :mod:`barbell_tpu.ops.oracle`),
- the Lodhi gap-weighted score carried along each cell's optimal path
  (move tie-breaking diag > up (pattern gap) > left (text gap), as in
  :func:`barbell_tpu.ops.device.window_dp_summary`),
- the best plateau-valley end position (key ``cost*256 + j``, minimised,
  as :func:`barbell_tpu.ops.device.best_valley_per_pattern`) and the
  Lodhi score there.

The jnp twin carries ``[H, P, W+1]`` state through m ``lax.scan`` rows
with associative scans in every row — several ``[H, P, W+1]`` arrays
through device memory per row.  Here one thread owns one lane: the whole
DP column (C, T1, T2, S over the m+1 pattern rows) is a loop carry in
registers, the loop runs over the window's text columns, and the
in-column "up" chain is the statically unrolled row sequence.  A block
is (BH windows x BP patterns); text and pattern bytes are pre-transposed
so each step loads one coalesced row of each.

Strand split: hit lanes arrive with forward hits in the first half and
rc hits in the second, and each half is ranked against its own strand's
P patterns only (half the lanes of ranking every hit against all 2P).

Float exactness: every Lodhi factor is 0.25 or 0.5 and every match flag
0 or 1, so each product is exact and each sum is rounded in the same
order as the jnp twin; FMA contraction cannot change a value.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .oracle import COST_SCALE

UNIT = COST_SCALE
BIG = 2**30
A_DIAG = 0.25  # lambda**2, lambda = 0.5
A_GAP = 0.5
BLOCK_H = 4  # windows per program
BLOCK_P = 32  # patterns per program (fewer when P is smaller)
NUM_WARPS = 4


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _kernel(pat_ref, win_ref, wlen_ref, key_ref, s_ref, *, m: int, W: int):
    BH = wlen_ref.shape[0]
    BP = pat_ref.shape[1]
    shape = (BH, BP)
    zi = jnp.zeros(shape, jnp.int32)
    zf = jnp.zeros(shape, jnp.float32)
    wlen = jnp.broadcast_to(wlen_ref[...][:, None], shape)
    row0 = (zi, zf, zf, zf)  # pattern row 0: free start, empty path

    def cell(pch, tch, dm1, left, up):
        """One DP cell; dm1/left/up/return are (C, T1, T2, S)."""
        eq = (pch & tch) != 0
        diag = dm1[0] + jnp.where(eq, 0, UNIT)
        lft = left[0] + UNIT
        upc = up[0] + UNIT
        c = jnp.minimum(jnp.minimum(diag, lft), upc)
        diag_ok = c == diag
        up_ok = c == upc
        mf = jnp.where(diag_ok & eq, 1.0, 0.0)
        a = jnp.where(diag_ok, A_DIAG, A_GAP)

        def src(k):
            return jnp.where(diag_ok, dm1[k], jnp.where(up_ok, up[k], left[k]))

        t1, t2, s = src(1), src(2), src(3)
        return (c, a * (t1 + mf), a * (t2 + mf * t1), s + mf * a * t2)

    def col_step(j, carry):
        col, prv, e_c, s_c, bk, bs = carry
        tch = jnp.broadcast_to(
            win_ref[j - 1, :].astype(jnp.int32)[:, None], shape
        )
        dm1 = row0  # row i-1 at column j-1
        up = row0  # row i-1 at column j
        new = []
        for i in range(1, m + 1):
            pch = jnp.broadcast_to(
                pat_ref[i - 1, :].astype(jnp.int32)[None, :], shape
            )
            left = col[i - 1]  # row i at column j-1
            up = cell(pch, tch, dm1, left, up)
            new.append(up)
            dm1 = left
        e_j = jnp.where(j <= wlen, up[0], BIG)
        # decide position j-1 now that its right neighbour is known
        isv = (e_c <= prv) & (e_c < e_j)
        key = jnp.where(isv, e_c, 0) * 256 + (j - 1)
        better = isv & (key < bk)
        bk = jnp.where(better, key, bk)
        bs = jnp.where(better, s_c, bs)
        return tuple(new), e_c, e_j, up[3], bk, bs

    init_col = tuple((zi + i * UNIT, zf, zf, zf) for i in range(1, m + 1))
    init = (init_col, zi + BIG, zi + m * UNIT, zf, zi + BIG, zf)
    _, prv, e_c, s_c, bk, bs = jax.lax.fori_loop(1, W + 1, col_step, init)
    # position W: right neighbour is +inf; masked positions carry BIG
    isv = (e_c <= prv) & (e_c < BIG)
    key = jnp.where(isv, e_c, 0) * 256 + W
    better = isv & (key < bk)
    key_ref[...] = jnp.where(better, key, bk)
    s_ref[...] = jnp.where(better, s_c, bs)


@functools.partial(jax.jit, static_argnames=("P", "split", "interpret"))
def rank_pass1(patterns, windows, w_len, *, P: int, split: bool,
               interpret: bool = False):
    """Best-valley key (cost*256 + pos) and Lodhi score per (h, p).

    patterns: [Pa, m] uint8 IUPAC masks — with ``split`` the fwd stack
              then the rc stack (Pa == 2P), else Pa == P patterns;
    windows:  [H, W] uint8 (content left-aligned, zero tail), W <= 255;
    w_len:    [H] int32 valid window length;
    split:    lanes [0, H/2) rank against patterns[:P], lanes [H/2, H)
              against patterns[P:] (H/2 must be a multiple of BLOCK_H).
    returns   key [H, P] int32, lodhi [H, P] float32 (strand-local
              pattern index under ``split``).
    """
    Pa, m = patterns.shape
    H0, W = windows.shape
    if W > 255:
        raise ValueError(f"valley key packs the position into 8 bits: W={W}")
    nst = 2 if split else 1
    if Pa != nst * P:
        raise ValueError(f"{Pa} patterns for P={P}, split={split}")
    BH = BLOCK_H
    BP = min(BLOCK_P, _pow2(P))
    Pp = -(-P // BP) * BP
    if split:
        if H0 % (2 * BH):
            raise ValueError(f"split rank needs H % {2 * BH} == 0, got {H0}")
        H = H0
    else:
        H = -(-H0 // BH) * BH
    if H != H0:  # dead lanes: empty windows
        windows = jnp.pad(windows, ((0, H - H0), (0, 0)))
        w_len = jnp.pad(w_len, (0, H - H0))
    # pad every strand's stack to Pp patterns and every block dim to a
    # power of two (the loops only visit the real m rows / W columns)
    stacks = patterns.reshape(nst, P, m)
    stacks = jnp.pad(stacks, ((0, 0), (0, Pp - P), (0, _pow2(m) - m)))
    pat_t = jnp.transpose(stacks.reshape(nst * Pp, -1), (1, 0))
    win_t = jnp.transpose(
        jnp.pad(windows, ((0, 0), (0, _pow2(W) - W))), (1, 0)
    )
    npb = Pp // BP
    half = (H // 2) // BH

    def pat_index(h, p):
        if split:  # h // half is the lane's strand: 0 fwd, 1 rc
            return (0, p + (h // half) * npb)
        return (0, p)

    key, s = pl.pallas_call(
        functools.partial(_kernel, m=m, W=W),
        out_shape=[
            jax.ShapeDtypeStruct((H, Pp), jnp.int32),
            jax.ShapeDtypeStruct((H, Pp), jnp.float32),
        ],
        grid=(H // BH, npb),
        in_specs=[
            pl.BlockSpec((pat_t.shape[0], BP), pat_index),
            pl.BlockSpec((win_t.shape[0], BH), lambda h, p: (0, h)),
            pl.BlockSpec((BH,), lambda h, p: (h,)),
        ],
        out_specs=[
            pl.BlockSpec((BH, BP), lambda h, p: (h, p)),
            pl.BlockSpec((BH, BP), lambda h, p: (h, p)),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="rank_pass1",
    )(pat_t, win_t, w_len.astype(jnp.int32))
    return key[:H0, :P], s[:H0, :P]
