"""The two-level factorization that ``csrc/rwkv_intra_bwd.cu`` computes,
rendered in plain torch and held to ``rwkv_intra_bwd_plain``.

The kernel runs only on the card; this file checks its arithmetic on the
CPU.  ``_two_level_bwd`` follows the kernel's phases: rows padded to
sub-chunks of 8 (padding rows zero and masked where an exponent would
meet them), dA over the sub-blocks, the diagonal blocks pairwise (each exp
used for A, P and Q), the off-diagonal P and Q through their one-exp
factors k[s] exp(L[b] - L[s]) = k'[s] D_ij and r[t] exp(Lex[t] - L[e]) =
r'[t] D_ij, scaled by alpha and beta (alpha 0 on padding rows), A's
off-diagonal blocks through r', k' and D_ij, and dv, dr, dk, dLex, dL and
du.  Stated tolerances: each gradient within ``WIDE_RTOL`` of its largest
magnitude in float64 and within ``INTRA_GRAD_RTOL`` (the kernel's own bound
on the card) in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vjp

from repro.kernels.rwkv_intra import rwkv_intra_ref
from repro_torch.kernels import rwkv_intra as intra_lib

S = 8  # the kernel's sub-chunk rows
WIDE_RTOL = 1e-12
INTRA_GRAD_RTOL = 1e-5  # tests/test_torch_train.py's bound, the kernel's on the card
NAMES = ("r", "k", "v", "lex", "lcum", "u")


def _case(g, c, n, decay_scale, seed):
    """tests/test_torch_train.py::_intra_case's inputs, with a bonus per cell."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (g, c, n)).astype(np.float32) for _ in range(3))
    lw = -(0.01 + (decay_scale - 0.01) * rng.random((g, c, n))).astype(np.float32)
    lcum = np.cumsum(lw, axis=1, dtype=np.float32)
    lex = (lcum - lw).astype(np.float32)
    u = rng.normal(0, 0.3, (g, n)).astype(np.float32)
    dy = rng.normal(0, 1, (g, c, n)).astype(np.float32)
    return r, k, v, lex, lcum, u, dy


def _two_level_bwd(r, k, v, lex, lcum, u, dy) -> tuple:
    """(dr, dk, dv, dlex, dlcum, du) by the kernel's two-level chunking, in
    the inputs' dtype."""
    g, c, n = r.shape
    ns = -(-c // S)
    cp = ns * S
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    r, k, v, lex, lcum, dy = map(pad, (r, k, v, lex, lcum, dy))
    rows = [slice(S * i, S * i + S) for i in range(ns)]
    # 1. dA over the whole square (the kernel stores the sub-blocks i >= j)
    da = torch.einsum("gtn,gsn->gts", dy, v)
    ddiag = torch.diagonal(da, dim1=1, dim2=2)
    a = torch.zeros((g, cp, cp), dtype=r.dtype)
    p = torch.zeros_like(r)
    q = torch.zeros_like(r)
    # 2. the diagonal blocks, pairwise; a padding row t takes no pair
    for i in range(ns):
        for t in range(S * i, min(S * i + S, c)):
            for s in range(S * i, t):
                e = torch.exp(lex[:, t] - lcum[:, s])
                ke = k[:, s] * e
                a[:, t, s] = torch.sum(r[:, t] * ke, -1)
                p[:, t] += da[:, t, s, None] * ke
                q[:, s] += da[:, t, s, None] * r[:, t] * e
    diag = torch.sum(r * u[:, None] * k, -1)
    a = a + torch.diag_embed(diag)
    # the factors: alpha of sub-chunks i >= 1 (0 on padding rows), beta of
    # sub-chunks i <= ns - 2, D_ij for j < i
    real = (torch.arange(cp) < c)[None, :, None]
    alpha = torch.zeros_like(r)
    beta = torch.zeros_like(r)
    for i in range(1, ns):
        alpha[:, rows[i]] = torch.where(real[:, rows[i]], torch.exp(lex[:, rows[i]] - lcum[:, S * i - 1, None]), 0.0)
    for i in range(ns - 1):
        beta[:, rows[i]] = torch.exp(lcum[:, S * i + S - 1, None] - lcum[:, rows[i]])
    # 3. P and Q of the off-diagonal blocks, their factors one exp each: for
    # s below sub-chunk i, k'[s] D_ij = k[s] exp(L[b] - L[s]); for t past
    # sub-chunk j, r'[t] D_ij = r[t] exp(Lex[t] - L[e]) (0 on padding rows)
    x = torch.zeros_like(r)
    y = torch.zeros_like(r)
    for i in range(1, ns):
        below = slice(0, S * i)
        kd = k[:, below] * torch.exp(lcum[:, S * i - 1, None] - lcum[:, below])
        x[:, rows[i]] = torch.einsum("gts,gsn->gtn", da[:, rows[i], below], kd)
    for j in range(ns - 1):
        past = slice(S * j + S, cp)
        rd = torch.where(real[:, past], r[:, past] * torch.exp(lex[:, past] - lcum[:, S * j + S - 1, None]), 0.0)
        y[:, rows[j]] = torch.einsum("gts,gtn->gsn", da[:, past, rows[j]], rd)
    p = p + alpha * x
    q = q + beta * y
    # 4-5. r', k' and A's off-diagonal blocks through them and D_ij
    rp, kp = r * alpha, k * beta
    for i in range(1, ns):
        for j in range(i):
            dij = torch.exp(lcum[:, S * i - 1] - lcum[:, S * j + S - 1])[:, None]  # (g, 1, n)
            a[:, rows[i], rows[j]] = torch.einsum("gtn,gsn->gts", rp[:, rows[i]] * dij, kp[:, rows[j]])
    # 6. dv = A^T dy over t >= s, and the elementwise gradients
    dv = torch.einsum("gts,gtn->gsn", torch.tril(a), dy)
    dr = p + ddiag[..., None] * u[:, None] * k
    dk = q + ddiag[..., None] * u[:, None] * r
    du = torch.sum(ddiag[..., None] * r * k, 1)
    return tuple(t[:, :c] for t in (dr, dk, dv, r * p, -k * q)) + (du,)


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("decay", [1.0, 50.0], ids=["decay1", "decay50"])
@pytest.mark.parametrize("n", [1, 30, 32, 64])
@pytest.mark.parametrize("c", [1, 7, 8, 9, 17, 57, 64])
def test_two_level_bwd_matches_plain(c, n, decay):
    ins = [torch.from_numpy(x) for x in _case(3, c, n, decay, seed=100 * c + n)]
    for dtype, rtol in ((torch.float64, WIDE_RTOL), (torch.float32, INTRA_GRAD_RTOL)):
        args = [t.to(dtype) for t in ins]
        got = _two_level_bwd(*args)
        want = intra_lib.rwkv_intra_bwd_plain(*args)
        for name, gt, wt in zip(NAMES, got, want):
            assert gt.shape == wt.shape and gt.dtype == dtype, name
            assert torch.isfinite(gt).all(), (name, dtype)
            assert _scaled_err(gt, wt) <= rtol, (name, dtype, _scaled_err(gt, wt))


def test_two_level_bwd_matches_reference_vjp():
    # the rendering against jax.vjp of the reference's rwkv_intra_ref, at a
    # ragged chunk with three sub-chunks (the reference's masked product
    # is NaN under strong decay, so decay scale 1 only)
    r, k, v, lex, lcum, u, dy = _case(4, 19, 16, 1.0, seed=7)
    _, pull = vjp(rwkv_intra_ref, *map(jnp.asarray, (r, k, v, lex, lcum, u)))
    want = [np.asarray(w, np.float64) for w in pull(jnp.asarray(dy))]
    got = _two_level_bwd(*(torch.from_numpy(x) for x in (r, k, v, lex, lcum, u, dy)))
    for name, gt, wt in zip(NAMES, got, want):
        assert _scaled_err(gt, torch.from_numpy(wt)) <= INTRA_GRAD_RTOL, name


def test_two_level_bwd_zero_gradient_and_underflow():
    # dy = 0 gives exact zeros; at decay scale 200 the factors underflow to 0
    # and every gradient stays finite and within the bound of the plain one
    r, k, v, lex, lcum, u, dy = (torch.from_numpy(x) for x in _case(2, 64, 64, 200.0, seed=11))
    zero = _two_level_bwd(r, k, v, lex, lcum, u, torch.zeros_like(dy))
    assert all(bool((t == 0).all()) for t in zero)
    got = _two_level_bwd(r, k, v, lex, lcum, u, dy)
    want = intra_lib.rwkv_intra_bwd_plain(r, k, v, lex, lcum, u, dy)
    for name, gt, wt in zip(NAMES, got, want):
        assert torch.isfinite(gt).all(), name
        assert _scaled_err(gt, wt) <= INTRA_GRAD_RTOL, name
