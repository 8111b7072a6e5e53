"""rwkv_intra: RWKV6's intra-chunk quadratic form, float32, and its gradient.

Replaces the TPU kernel ``repro/kernels/rwkv_intra.py::rwkv_intra``
(``_intra_kernel``), which computes, for each of G = B * NC * H cells (one
chunk of one head of one sequence) of (C, N) tiles::

    A[t,s]  = sum_n r[t,n] k[s,n] exp(Lex[t,n] - L[s,n])     (s < t)
    diag[t] = sum_n r[t,n] u[n] k[t,n]
    y[t]    = sum_{s<t} A[t,s] v[s] + diag[t] v[t]

the term ``models/rwkv6.py::time_mix_chunked`` adds to the inter-chunk
term.  The CUDA source is ``csrc/rwkv_intra.cu``: one block per cell,
the five tiles and u copied into dynamic shared memory with ``cp.async``,
and two-level chunking (GLA, arXiv:2312.06635, sec. 4).  The C rows split
into sub-chunks of 8 rows; a diagonal sub-block keeps the
pairwise exp(Lex[t] - L[s]), and an off-diagonal one (i > j) factors it
through e, the last row of sub-chunk j, and b, the row before sub-chunk
i::

    exp(Lex[t] - L[s]) = exp(Lex[t] - L[b]) * exp(L[b] - L[e]) * exp(L[e] - L[s])

so that it is a small dense product of r and k scaled once each.  Domain:
log-decays <= 0 (rwkv6's ``log_w = -exp(.)``, every caller in the port),
so L does not increase along the chunk, t > b >= e >= s makes every
exponent <= 0, and no factor overflows even under strong decay; the
pairwise exp is never factored across the whole chunk, where exp(-L)
alone overflows.  What bounds it on the H100 at the serve shape
(G = 5120, C = N = 64): bytes, 504.6 MB read and written once, 0.151 ms
at 3.35 TB/s, against 0.061 ms for its ~4.1 GFLOP of float32 at
67 TFLOP/s.  It takes 1 <= C <= 64 and 1 <= N <= 64 (the model's chunk is
C = 64, or the whole prompt when it is shorter; N is the head width, 64
at full size and 32 in the reduced config); a ragged last sub-chunk is
masked.

``rwkv_intra_bwd`` is the gradient (``csrc/rwkv_intra_bwd.cu``; its
formulas are in the source).  It has no Pallas counterpart: the reference
differentiates its inline chunk math with ``jax.grad``.  ``models/rwkv6.py``
pairs the two in a ``torch.autograd.Function``.  It chunks in two levels
as the forward does: the diagonal 8 x 8 sub-blocks keep the pairwise exp,
each used for A, P and Q at once, and the off-diagonal ones go through
the same factors (r' = r alpha, k' = k beta, D_ij), so that A, P, Q, dA and
dv are small dense products in register tiles, float32 on the CUDA cores.
One block of 256 threads a cell, 109,824 bytes of shared memory, two
blocks an SM, the tiles copied with ``cp.async`` in two groups.  What
bounds it on the H100 at the training grid (G, C, N) = (1280, 64, 64):
bytes, 231.3 MB read and written once, 0.0691 ms at 3.35 TB/s, against
~0.027 ms for its ~1.8 GFLOP; the kernel itself spends its time on the
shared-memory loads of its products (``tools/intra_bwd_probe.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.obs import costs

MAX_C = 64
MAX_N = 64
PLAIN_BLOCK_CELLS = 512  # the plain version's (g, C, C, N) transient: 512 MiB at C = N = 64

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def intra_flops(g: int, c: int, n: int) -> int:
    """float32 operations of rwkv_intra on (G, C, N) cells: per pair s < t and
    n a subtract, two multiplies and an add (the exp not counted); per (t, n)
    three for the diagonal; per (t, s <= t, n) a multiply-add for y."""
    return g * n * (4 * (c * (c - 1) // 2) + 3 * c + 2 * (c * (c + 1) // 2))


def intra_bwd_flops(g: int, c: int, n: int) -> int:
    """float32 operations of rwkv_intra_bwd on (G, C, N) cells, the exps not
    counted: per pair s < t and n, A's subtract, two multiplies and add, dA's
    multiply-add, and P's and Q's subtract, two multiplies and add; per
    (s <= t, n) dv's multiply-add; per (t, n) the diagonal terms of A, dA,
    dr, dk, dLex, dL and du (12)."""
    pairs = c * (c - 1) // 2
    return g * n * (pairs * (4 + 2 + 4 + 4) + 2 * (c * (c + 1) // 2) + 12 * c)


def _cost(g: int, c: int, n: int):
    """Five float32 tiles and u in, one tile out."""
    return intra_flops(g, c, n), 4 * (6 * g * c * n + g * n)


def _bwd_cost(g: int, c: int, n: int):
    """Six float32 tiles and u in, five tiles and du out."""
    return intra_bwd_flops(g, c, n), 4 * (11 * g * c * n + 2 * g * n)


def _check(r, k, v, lex, lcum, u) -> tuple:
    if r.dim() != 3:
        raise ValueError(f"r must be (G, C, N), got {tuple(r.shape)}")
    g, c, n = r.shape
    for name, t in (("k", k), ("v", v), ("lex", lex), ("lcum", lcum)):
        if t.shape != r.shape:
            raise ValueError(f"{name} must be {tuple(r.shape)} like r, got {tuple(t.shape)}")
    if u.shape != (g, n):
        raise ValueError(f"u must be ({g}, {n}), got {tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lex", lex), ("lcum", lcum), ("u", u)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    return g, c, n


def _plain_dtype(*tensors) -> torch.dtype:
    """float32, or float64 where an input is float64 (the tests' oracle)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32


def _plain_block(rf, kf, vf, lexf, lf, uf) -> torch.Tensor:
    """``rwkv_intra_ref``'s math on one block of cells, in the inputs' dtype.

    The pairs s >= t are masked in the exponent (exp(-inf) = 0), where the
    reference masks the product: the values are the same, but above the
    diagonal Lex[t] - L[s] > 0 and, under strong decay, its exp overflows,
    so masking the product leaves inf * 0 = NaN in the gradient (the
    reference's ``jax.grad`` of its chunk math has that trap; the kernels
    take no exp there)."""
    c = rf.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=rf.device), diagonal=-1)[None, :, :, None]
    pair = torch.where(mask, lexf[:, :, None, :] - lf[:, None, :, :], -torch.inf)  # (g, C, C, N)
    a = torch.sum(rf[:, :, None] * kf[:, None, :] * torch.exp(pair), dim=-1)
    diag = torch.einsum("gtn,gn,gtn->gt", rf, uf, kf)
    return torch.einsum("gts,gsn->gtn", a, vf) + diag[..., None] * vf


def rwkv_intra_plain(r, k, v, lex, lcum, u) -> torch.Tensor:
    """The plain PyTorch version: ``rwkv_intra_ref``'s math, in blocks of
    cells, in float32 (float64 for float64 inputs)."""
    g, c, n = _check(r, k, v, lex, lcum, u)
    dt = _plain_dtype(r, k, v, lex, lcum, u)
    full = [t.to(dt) for t in (r, k, v, lex, lcum, u)]
    out = [_plain_block(*(t[lo : lo + PLAIN_BLOCK_CELLS] for t in full)) for lo in range(0, g, PLAIN_BLOCK_CELLS)]
    return torch.cat(out) if out else torch.zeros((0, c, n), dtype=dt, device=r.device)


def rwkv_intra(r, k, v, lex, lcum, u) -> torch.Tensor:
    """Intra-chunk output (G, C, N) float32 of (G, C, N) tiles and (G, N) bonuses.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    tensors = (r, k, v, lex, lcum, u)
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv_intra_plain(*tensors)
    g, c, n = _check(*tensors)
    if not (1 <= c <= MAX_C and 1 <= n <= MAX_N):
        raise ValueError(f"the kernel takes 1 <= C <= {MAX_C} and 1 <= N <= {MAX_N}, got C={c}, N={n}")
    if _build.on_meta(*tensors):
        costs.kernel("rwkv_intra", *_cost(g, c, n))
        return torch.empty((g, c, n), dtype=torch.float32, device="meta")
    device = _build.require_cuda(*tensors)
    rf, kf, vf, lexf, lf, uf = (t.to(torch.float32).contiguous() for t in tensors)
    y = torch.empty((g, c, n), dtype=torch.float32, device=device)
    if g == 0:
        return y
    _build.launch("rwkv_intra", "rwkv_intra", "rwkv_intra_launch", _ARGTYPES, device,
                  (rf.data_ptr(), kf.data_ptr(), vf.data_ptr(), lexf.data_ptr(), lf.data_ptr(), uf.data_ptr(),
                   y.data_ptr(), g, c, n),
                  *_cost(g, c, n))
    return y


# ----------------------------------------------------------------------------
# the gradient
# ----------------------------------------------------------------------------

_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def rwkv_intra_bwd_plain(r, k, v, lex, lcum, u, dy) -> tuple:
    """The plain PyTorch version of the gradient: autograd of
    ``rwkv_intra_plain``'s math, recomputed block by block over
    PLAIN_BLOCK_CELLS cells so that its transient stays bounded.  Returns
    (dr, dk, dv, dlex, dlcum, du), du per cell (G, N), in float32 (float64
    for float64 inputs)."""
    g, c, n = _check(r, k, v, lex, lcum, u)
    if dy.shape != r.shape:
        raise ValueError(f"dy must be {tuple(r.shape)} like r, got {tuple(dy.shape)}")
    dt = _plain_dtype(r, k, v, lex, lcum, u, dy)
    full = [t.detach().to(dt) for t in (r, k, v, lex, lcum, u)]
    dyf = dy.detach().to(dt)
    grads = [[] for _ in full]
    with torch.enable_grad():
        for lo in range(0, g, PLAIN_BLOCK_CELLS):
            block = [t[lo : lo + PLAIN_BLOCK_CELLS].clone().requires_grad_(True) for t in full]
            y = _plain_block(*block)
            for acc, grad in zip(grads, torch.autograd.grad(y, block, dyf[lo : lo + PLAIN_BLOCK_CELLS])):
                acc.append(grad)
    if g == 0:
        return tuple(torch.zeros_like(t) for t in full)
    return tuple(torch.cat(acc) for acc in grads)


def rwkv_intra_bwd(r, k, v, lex, lcum, u, dy) -> tuple:
    """(dr, dk, dv, dlex, dlcum, du) float32 of ``rwkv_intra``'s inputs, given
    the output's gradient dy (G, C, N); du is per cell, (G, N): the caller
    sums it where its bonus is shared.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (``csrc/rwkv_intra_bwd.cu``).
    """
    tensors = (r, k, v, lex, lcum, u, dy)
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv_intra_bwd_plain(*tensors)
    g, c, n = _check(*tensors[:6])
    if dy.shape != r.shape:
        raise ValueError(f"dy must be {tuple(r.shape)} like r, got {tuple(dy.shape)}")
    if not (1 <= c <= MAX_C and 1 <= n <= MAX_N):
        raise ValueError(f"the kernel takes 1 <= C <= {MAX_C} and 1 <= N <= {MAX_N}, got C={c}, N={n}")
    if _build.on_meta(*tensors):
        costs.kernel("rwkv_intra_bwd", *_bwd_cost(g, c, n))
        return tuple(torch.empty(shape, dtype=torch.float32, device="meta")
                     for shape in [(g, c, n)] * 5 + [(g, n)])
    device = _build.require_cuda(*tensors)
    ins = [t.to(torch.float32).contiguous() for t in tensors]
    outs = [torch.empty((g, c, n), dtype=torch.float32, device=device) for _ in range(5)]
    outs.append(torch.empty((g, n), dtype=torch.float32, device=device))
    if g == 0:
        return tuple(outs)
    _build.launch("rwkv_intra_bwd", "rwkv_intra_bwd", "rwkv_intra_bwd_launch", _BWD_ARGTYPES, device,
                  (*(t.data_ptr() for t in ins + outs), g, c, n), *_bwd_cost(g, c, n))
    return tuple(outs)
