"""Closed-form linear algebra on the device: Gram matrices, the EASE solve,
truncated SVD.

Port of rectools_tpu/ops/linalg.py. Every product runs in full f32 (TF32
off, ``full_f32_matmul``), where JAX multiplies at ``Precision.HIGHEST``. The
solver dispatch is JAX's: ``"auto"`` takes the direct factorization
(``torch.linalg.cholesky`` / ``cholesky_solve`` / ``eigh``, cuSOLVER on the
card) up to ``_DIRECT_SOLVER_MAX_N`` and the iterative algorithms beyond
(Newton–Schulz for the SPD inverse, randomized subspace iteration for the
leading eigenpairs); ``"exact"`` / ``"iterative"`` force one path at any size.
No Pallas kernel lies behind any of them.

The subspace iteration orthonormalizes its block by Householder QR where JAX
uses a shifted Cholesky QR, which breaks down in f32 on skewed catalogs
(``_ortho``). The random starting block of the subspace iteration comes from a
``torch.Generator`` seeded with ``seed`` on the Gram's device; ``q0`` takes a
given block instead (the tests pass JAX's ``jax.random.normal`` draws).

JAX's ``mesh`` argument (the sharded Gram accumulation) is not ported; the
models refuse a ``mesh_shape`` with :func:`refuse_mesh`.
"""

import typing as tp
import warnings

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, full_f32_matmul, host_to_device, resolve_device

SolverKind = tp.Any  # tpe.Literal["auto", "exact", "iterative"]
_SOLVER_KINDS = ("auto", "exact", "iterative")

# The JAX package's threshold, kept so that "auto" computes what JAX computes.
# It was set from a TPU measurement; its value for the H100 is open (ROADMAP.md).
_DIRECT_SOLVER_MAX_N = 1024


def _check_solver(solver: str) -> str:
    if solver not in _SOLVER_KINDS:
        raise ValueError(f"solver must be one of {_SOLVER_KINDS}, got {solver!r}")
    return solver


def refuse_mesh(mesh_shape: tp.Any) -> None:
    """Raise for a model's ``mesh_shape``: sharding is not ported."""
    if mesh_shape is not None:
        raise NotImplementedError(
            "a mesh for the Gram matrix and the factorizations is not ported yet "
            "(ROADMAP.md §1 item 6, multi-device)"
        )


def gram_matrix(
    ui_csr: sparse.csr_matrix, block_rows: int = 8192, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """X^T X on ``device`` (f32), accumulated over dense row blocks of the CSR
    matrix. A tall matrix (``n_users > 4 * n_items``) is multiplied on the host
    by scipy and uploaded once, as in JAX: the dense blocks would move far
    more bytes than the sparse product reads."""
    dev = resolve_device(device)
    n_users, n_items = ui_csr.shape
    if n_users > 4 * n_items:
        gram_host = (ui_csr.T @ ui_csr).toarray().astype(np.float32)
        return host_to_device(gram_host, dev)
    gram = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    with full_f32_matmul():
        for start in range(0, n_users, block_rows):
            block = host_to_device(np.asarray(ui_csr[start : start + block_rows].todense(), dtype=np.float32), dev)
            gram += block.T @ block
    return gram


def _max_abs_sum(a: torch.Tensor, dim: int) -> torch.Tensor:
    return a.abs().sum(dim=dim).max()


def _newton_seed(a: torch.Tensor) -> tp.Tuple[torch.Tensor, float]:
    """The better convergent seed and its residual max|A X0 - I| (JAX
    ``_newton_seed``): the Jacobi seed diag(1/diag(A)) when the bound
    sqrt(|M|_1 |M|_inf) of its spectral residual is below 0.99, else the
    universal seed A^T / (|A|_1 |A|_inf)."""
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    x_uni = a.T / (_max_abs_sum(a, 0) * _max_abs_sum(a, 1))
    x_jac = torch.diag(1.0 / torch.diagonal(a))
    m_jac = a @ x_jac - eye
    spectral_bound = torch.sqrt(_max_abs_sum(m_jac, 0) * _max_abs_sum(m_jac, 1))
    if float(spectral_bound) < 0.99:
        return x_jac, float(m_jac.abs().max())
    return x_uni, float((a @ x_uni - eye).abs().max())


def _newton_chunk(a: torch.Tensor, x: torch.Tensor, steps: int) -> tp.Tuple[torch.Tensor, float]:
    """``steps`` Newton–Schulz iterations X <- X (2I - A X), then the residual
    max|A X - I|. All f32: the JAX package found bf16 iterations diverge."""
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    for _ in range(steps):
        x = x @ (2.0 * eye - a @ x)
    return x, float((a @ x - eye).abs().max())


def _spd_inverse_newton(a: torch.Tensor, maxiter: int, tol: float, chunk: int = 8) -> torch.Tensor:
    """SPD inverse by Newton–Schulz iteration in chunks of ``chunk`` steps with
    the convergence check on the host between chunks, and JAX's f32-floor stop:
    once the residual is under 1e-3, a chunk that does not halve it ends the
    loop (with a warning if ``tol`` is not met)."""
    x, res = _newton_seed(a)
    best = res
    done = 0
    while done < maxiter and res > tol:
        x, res = _newton_chunk(a, x, chunk)
        done += chunk
        if res < 1e-3 and res >= best * 0.5:
            if res > tol:
                warnings.warn(
                    f"Newton-Schulz SPD inverse stalled at the f32 residual floor: "
                    f"max|AX - I| = {res:.2e} after {done} iterations (requested tol {tol:.0e}). "
                    f"Pass solver='exact' for the direct factorization if this matters.",
                    RuntimeWarning,
                )
            break
        best = min(best, res)
    return x


def _spd_inverse_cholesky(a: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    return torch.cholesky_solve(eye, torch.linalg.cholesky(a))


def spd_inverse(a: torch.Tensor, maxiter: int = 200, tol: float = 1e-6, solver: SolverKind = "auto") -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix on its device: a
    Cholesky solve up to ``_DIRECT_SOLVER_MAX_N`` (or with ``solver="exact"``),
    Newton–Schulz beyond (or with ``solver="iterative"``), which targets
    max|AX - I| <= ``tol``."""
    _check_solver(solver)
    with full_f32_matmul():
        if solver == "exact" or (solver == "auto" and a.shape[0] <= _DIRECT_SOLVER_MAX_N):
            return _spd_inverse_cholesky(a)
        return _spd_inverse_newton(a, maxiter, float(tol))


def ease_weight(
    ui_csr: sparse.csr_matrix,
    regularization: float,
    solver: SolverKind = "auto",
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """EASE closed-form weights: W = G^-1 / (-diag(G^-1)) with a zero diagonal,
    G the regularized Gram (reference ease.py:122-132)."""
    gram = gram_matrix(ui_csr, device=device)
    n = gram.shape[0]
    p = spd_inverse(gram + float(regularization) * torch.eye(n, dtype=torch.float32, device=gram.device),
                    solver=solver)
    w = p / (-torch.diagonal(p))[None, :]
    w.fill_diagonal_(0.0)
    return w.cpu().numpy()


def _topk_eigh(gram: torch.Tensor, factors: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    eigvals, eigvecs = torch.linalg.eigh(gram)  # ascending
    return eigvals[-factors:].flip(0), eigvecs[:, -factors:].flip(1)


def _ortho(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of a tall block's columns: Householder QR, columns
    signed so that R's diagonal is positive (the Q of JAX's Cholesky QR in
    exact arithmetic). JAX factors the shifted (k, k) Gram y^T y instead,
    whose f32 rounding (~1e-7 of its largest entry) exceeds the shift (1e-6
    of its mean diagonal) once the block's condition number passes ~3,000:
    its Cholesky then fails and the factors come out NaN (PureSVD at 64
    factors on a Zipf-skewed catalog)."""
    q, r = torch.linalg.qr(y)
    return q * torch.where(torch.diagonal(r) < 0, -1.0, 1.0)


def _subspace_topk_eigh(
    gram: torch.Tensor, factors: int, oversample: int, maxiter: int, tol: float, q0: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Top-``factors`` eigenpairs of a PSD Gram by subspace iteration from the
    (n, factors + oversample) block ``q0``: one (n, n) x (n, k) product and a
    QR a step, until the largest relative change of the leading
    Rayleigh quotients drops to ``tol`` (read on the host each step, where
    JAX's ``while_loop`` reads it on the device), then Rayleigh–Ritz."""
    q = _ortho(q0)
    y = gram @ q
    for _ in range(maxiter):
        q_next = _ortho(y)
        y_next = gram @ q_next
        lead_prev = torch.sort((q * y).sum(dim=0), descending=True).values[:factors]
        lead_next = torch.sort((q_next * y_next).sum(dim=0), descending=True).values[:factors]
        delta = ((lead_next - lead_prev).abs() / torch.clamp(lead_next.abs(), min=1e-30)).max()
        q, y = q_next, y_next
        if not float(delta) > tol:  # JAX's loop condition, NaN included
            break
    b = q.T @ y
    w, u = torch.linalg.eigh((b + b.T) / 2.0)
    return w[-factors:].flip(0), (q @ u)[:, -factors:].flip(1)


def topk_eigh(
    gram: torch.Tensor,
    factors: int,
    tol: float = 0.0,
    maxiter: tp.Optional[int] = None,
    seed: int = 0,
    solver: SolverKind = "auto",
    q0: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Leading eigenpairs (values descending, vectors as columns) of a PSD
    matrix: the full ``eigh`` for small matrices, subspace iteration beyond
    ``_DIRECT_SOLVER_MAX_N`` or with a ``maxiter``. ``tol`` 0 means 1e-7
    relative change of the Rayleigh quotients; ``maxiter`` None means 300.
    ``q0``: the (n, factors + oversample) starting block, else standard normal
    draws from a generator seeded with ``seed``."""
    _check_solver(solver)
    with full_f32_matmul():
        if solver == "exact" or (solver == "auto" and gram.shape[0] <= _DIRECT_SOLVER_MAX_N and maxiter is None):
            return _topk_eigh(gram, factors)
        n = gram.shape[0]
        tol_eff = 1e-7 if tol == 0 else float(tol)
        maxiter_eff = 300 if maxiter is None else int(maxiter)
        oversample = int(min(max(16, factors // 2), n - factors))
        if q0 is None:
            generator = torch.Generator(device=gram.device).manual_seed(int(seed))
            q0 = torch.randn((n, min(factors + oversample, n)), generator=generator, device=gram.device)
        q0 = q0.to(device=gram.device, dtype=torch.float32)
        return _subspace_topk_eigh(gram, factors, oversample, maxiter_eff, float(np.float32(tol_eff)), q0)


def truncated_svd(
    ui_csr: sparse.csr_matrix,
    factors: int,
    block_rows: int = 8192,
    tol: float = 0.0,
    maxiter: tp.Optional[int] = None,
    random_state: tp.Optional[int] = None,
    solver: SolverKind = "auto",
    device: DeviceLike = "cuda",
    q0: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Truncated SVD X ~= U diag(s) V^T from the eigenpairs of the item Gram.
    Returns (user_factors = U, item_factors = V diag(s)), the convention of
    reference pure_svd.py:152-167; U = X V diag(1/s) on the host in row
    blocks."""
    n_users, n_items = ui_csr.shape
    if factors > min(n_users, n_items) - 1:
        raise ValueError("`factors` must be less than min(n_users, n_items)")
    gram = gram_matrix(ui_csr, block_rows, device=device)
    eigvals, v = topk_eigh(
        gram, factors, tol=tol, maxiter=maxiter, seed=0 if random_state is None else int(random_state),
        solver=solver, q0=q0,
    )
    eigvals = eigvals.cpu().numpy()
    v = v.cpu().numpy()
    sigma = np.sqrt(np.clip(eigvals, 0.0, None))
    sigma_safe = np.where(sigma > 0, sigma, 1.0)
    v_scaled = v / sigma_safe[None, :]
    u = np.zeros((n_users, factors), dtype=np.float32)
    for start in range(0, n_users, block_rows):
        u[start : start + block_rows] = ui_csr[start : start + block_rows] @ v_scaled
    item_factors = v * sigma[None, :]
    return u.astype(np.float32), item_factors.astype(np.float32)
