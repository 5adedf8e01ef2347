"""The small batched linear algebra of the perspective fits (PyTorch + K10, K11).

Counterparts of two library calls the JAX package makes inside its
single-program perspective estimation, which XLA lowers without a
``pallas_call``:

- ``jnp.linalg.eigh`` in the DLT refit (``comfyui_video_stabilizer_tpu/
  ops/ransac.py:112`` ``_refit_homography``): the eigenvector of the
  smallest eigenvalue of each (B, 9, 9) normal matrix.  K10
  (``csrc/linalg.cu``, ``smallest_eigvec``) runs Jacobi in the parallel
  (round-robin) order, one warp a matrix.
- ``jnp.linalg.solve`` of the 4-point homography systems (``ops/
  ransac.py:60`` ``_solve_homography_4pt``) and of the IRLS pre-warp's
  normal equations (``ops/flow_dis.py:341``): K11 (``csrc/linalg.cu``),
  Gaussian elimination with partial pivoting on each 8x8 system, one
  thread a system, a block's systems staged through shared memory.  Its
  4-point entry (``solve_homography_4pt``) builds each hypothesis's
  system from its four correspondences itself; the general entry
  (``solve8``) takes the systems.

The port calls neither ``torch.linalg.eigh`` nor ``torch.linalg.solve_ex``
for them: both read the card on the host (``eigh`` checks the library's
info, a batched LU may run through MAGMA, which synchronizes), so a
CUDA graph cannot hold them; these kernels can.

The wrappers follow their tensors' device: a CUDA tensor launches the
kernel (raising if it cannot build, launch, or take the arguments), a
CPU tensor takes the plain version.  The plain versions repeat each
kernel's arithmetic op for op, batched with per-matrix masks, every
division a division by a tensor, so the kernels (built with
``-fmad=false``) are ``torch.equal`` to them on the card.

Jacobi (K10).  A sweep visits the 36 pairs (p, q), p < q, in 9 rounds
of 4 disjoint pairs (``ROUNDS``: round r pairs r + k and r - k mod 9,
k = 1..4, and leaves index r out).  A pair rotates when ``|a_pq| >
2**-23 * sqrt|a_pp| * sqrt|a_qq|`` (the relative test that keeps the
small eigenvalues' accuracy), with the classic rotation::

    theta = (a_qq - a_pp) / (2 a_pq)
    t = sign(theta) / (|theta| + sqrt(theta^2 + 1)),  c = 1 / sqrt(t^2 + 1),  s = t c
    a_kp <- c a_kp - s a_kq,  a_kq <- s a_kp + c a_kq   (k != p, q; both triangles)
    a_pp <- a_pp - t a_pq,  a_qq <- a_qq + t a_pq,  a_pq <- 0
    v_kp <- c v_kp - s v_kq,  v_kq <- s v_kp + c v_kq   (all k)

The kernel takes a round's four tests and rotations from the matrix as
the round found it and applies them together, an entry where two
rotated pairs cross getting the earlier pair's rotation first.  No
rotation of a round reads or writes another one's a_pp, a_qq or a_pq,
so that is exactly the four rotations one after the other, as the
plain version runs them.

A sweep that rotates nothing ends the matrix's iteration (it is then a
fixed point: a further sweep tests the same numbers), as does the
``JACOBI_SWEEPS``-th sweep.  The result is the column of V at the
smallest diagonal entry, the first on ties.  Its sign is arbitrary, as
LAPACK's: the refit divides by h22.

Elimination (K11).  For k = 0..7 the pivot is the first row i >= k of
largest ``|a_ik|`` (a strict ``>`` walk from row k), rows k and the
pivot swap (A and b), then each row i > k subtracts ``l * row k`` with
``l = a_ik * (1 / a_kk)`` (``a_ik / a_kk`` where ``|a_kk|`` is below
the smallest normal float32), as LAPACK's ``sgetf2`` scales the column
by the pivot's reciprocal; back substitution sums ``a_ij x_j`` for j =
i+1..7 in order and divides by ``a_ii``.  A zero pivot gives the IEEE
non-finite result on both sides, so ``hyp_ok`` rejects the same draws.
The 4-point entry's system is the JAX package's: rows ``[x, y, 1, 0, 0,
0, -x u, -y u]`` and ``[0, 0, 0, x, y, 1, -x v, -y v]`` (``-x u`` the
product of the negation), then ``1e-12 I`` added to every entry (a -0
becomes +0), right-hand side ``[u, v]``; the homography is the solution
and h22 = 1.
"""

from __future__ import annotations

import torch

from . import cuda_build

# the relative rotation test's tolerance (2**-23, float32's epsilon)
JACOBI_TOL = 2.0 ** -23
# sweeps at most (a 9x9 normal matrix stops after 5-7, the last one rotating nothing)
JACOBI_SWEEPS = 24
N_EIG = 9
N_SOLVE = 8
# the smallest normal float32: K11 scales by a pivot's reciprocal at or above it
FLT_MIN = 2.0 ** -126
# the rounds of a sweep: 4 disjoint pairs each, every pair once a sweep
ROUNDS = tuple(tuple(tuple(sorted(((r + k) % N_EIG, (r - k) % N_EIG))) for k in range(1, 5))
               for r in range(N_EIG))
# the pairs of a sweep, in the order the plain version rotates them
PAIRS = tuple(pair for rnd in ROUNDS for pair in rnd)
# the 4-point systems' ridge (the JAX package's A + 1e-12 I)
RIDGE = 1e-12


def smallest_eigvec_plain(mats: torch.Tensor, counts: dict | None = None,
                          pairs: tuple = PAIRS) -> torch.Tensor:
    """Plain PyTorch version of K10: (B, 9, 9) symmetric float32 -> (B, 9),
    rotating ``pairs`` in order each sweep (K10's: ``PAIRS``).

    Runs sweeps until no matrix rotates (a host read, taken only where
    this version runs: the CPU, and the card's comparisons) or the
    cap; a matrix that has stopped is a fixed point, so the extra sweeps
    leave it as the kernel does.  ``counts``, when given, receives the
    rotation tests and the rotations the kernel makes on these matrices
    ("tests", "rotations": the work a bound counts)."""
    m = mats.to(torch.float32)
    B = m.shape[0]
    upper = torch.ones((N_EIG, N_EIG), dtype=torch.bool, device=m.device).triu()
    a = torch.where(upper, m, m.transpose(1, 2))  # the upper triangle, as the kernel reads it
    v = torch.eye(N_EIG, dtype=torch.float32, device=a.device).repeat(B, 1, 1)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    active = torch.ones(B, dtype=torch.bool, device=a.device)
    tests = rotations = 0
    for _ in range(JACOBI_SWEEPS):
        rotated = torch.zeros(B, dtype=torch.bool, device=a.device)
        for p, q in pairs:
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            rot = apq.abs() > JACOBI_TOL * (torch.sqrt(app.abs()) * torch.sqrt(aqq.abs()))
            theta = (aqq - app) / (2.0 * apq)
            t = one / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta < 0, -t, t)
            c = one / torch.sqrt(t * t + 1.0)
            s = t * c
            cc, ss = c[:, None], s[:, None]
            colp = cc * a[:, :, p] - ss * a[:, :, q]
            colq = ss * a[:, :, p] + cc * a[:, :, q]
            new_app = app - t * apq
            new_aqq = aqq + t * apq
            b = a.clone()
            b[:, :, p], b[:, :, q] = colp, colq
            b[:, p, :], b[:, q, :] = colp, colq
            b[:, p, p], b[:, q, q] = new_app, new_aqq
            b[:, p, q] = zero
            b[:, q, p] = zero
            vp = cc * v[:, :, p] - ss * v[:, :, q]
            vq = ss * v[:, :, p] + cc * v[:, :, q]
            w = v.clone()
            w[:, :, p], w[:, :, q] = vp, vq
            a = torch.where(rot[:, None, None], b, a)
            v = torch.where(rot[:, None, None], w, v)
            rotated |= rot
            if counts is not None:
                rotations += int(rot.sum())
        if counts is not None:
            tests += len(pairs) * int(active.sum())
        active = rotated
        if not bool(rotated.any()):
            break
    if counts is not None:
        counts.update(tests=tests, rotations=rotations)
    best = a[:, 0, 0]
    idx = torch.zeros(B, dtype=torch.int64, device=a.device)
    for i in range(1, N_EIG):
        smaller = a[:, i, i] < best
        best = torch.where(smaller, a[:, i, i], best)
        idx = torch.where(smaller, i, idx)
    return torch.gather(v, 2, idx[:, None, None].expand(B, N_EIG, 1))[..., 0]


def smallest_eigvec(mats: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of the smallest eigenvalue of each symmetric
    (B, 9, 9) float32 matrix, (B, 9) (module docstring).  The matrices
    must be finite; only the upper triangle is read on the card.

    CUDA tensors launch K10; CPU tensors take the plain version."""
    if mats.device.type == "cpu":
        return smallest_eigvec_plain(mats)
    cuda_build.require_cuda_tensor("mats", mats, torch.float32, 3)
    B = mats.shape[0]
    if B < 1 or tuple(mats.shape[1:]) != (N_EIG, N_EIG):
        raise cuda_build.KernelArgumentError(f"K10 takes (B >= 1, 9, 9) matrices, got {tuple(mats.shape)}")
    out = torch.empty((B, N_EIG), dtype=torch.float32, device=mats.device)
    with torch.cuda.device(mats.device):
        err = cuda_build.library().cvst_smallest_eigvec(
            mats.data_ptr(), out.data_ptr(), B, JACOBI_SWEEPS, cuda_build.current_stream(mats.device))
        cuda_build.check_launch(err, "smallest_eigvec")
        cuda_build.LAUNCHES["smallest_eigvec"] += 1
    return out


def solve8_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11: A (N, 8, 8), b (N, 8) float32 -> x (N, 8)."""
    a = A.to(torch.float32).clone()
    r = b.to(torch.float32).clone()
    n = a.shape[0]
    one = torch.ones((), dtype=torch.float32, device=a.device)
    for k in range(N_SOLVE):
        best = a[:, k, k].abs()
        piv = torch.full((n,), k, dtype=torch.int64, device=a.device)
        for i in range(k + 1, N_SOLVE):
            cand = a[:, i, k].abs()
            larger = cand > best
            best = torch.where(larger, cand, best)
            piv = torch.where(larger, i, piv)
        for i in range(k + 1, N_SOLVE):
            swap = piv == i
            row_k, row_i = a[:, k].clone(), a[:, i].clone()
            a[:, k] = torch.where(swap[:, None], row_i, row_k)
            a[:, i] = torch.where(swap[:, None], row_k, row_i)
            r_k, r_i = r[:, k].clone(), r[:, i].clone()
            r[:, k] = torch.where(swap, r_i, r_k)
            r[:, i] = torch.where(swap, r_k, r_i)
        if k + 1 < N_SOLVE:
            akk = a[:, k, k, None]
            l = torch.where(akk.abs() >= FLT_MIN, a[:, k + 1:, k] * (one / akk), a[:, k + 1:, k] / akk)
            a[:, k + 1:, k + 1:] = a[:, k + 1:, k + 1:] - l[:, :, None] * a[:, k, None, k + 1:]
            r[:, k + 1:] = r[:, k + 1:] - l * r[:, k, None]
    x = torch.empty_like(r)
    for i in range(N_SOLVE - 1, -1, -1):
        s = r[:, i]
        for j in range(i + 1, N_SOLVE):
            s = s - a[:, i, j] * x[:, j]
        x[:, i] = s / a[:, i, i]
    return x


def solve8(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for every (..., 8, 8) float32 system and (..., 8)
    right-hand side, (..., 8) (module docstring); no error check: a
    singular system gives non-finite entries, as ``solve_ex`` without
    checks did.

    CUDA tensors launch K11; CPU tensors take the plain version."""
    lead = tuple(A.shape[:-2])
    if A.shape[-2:] != (N_SOLVE, N_SOLVE) or tuple(b.shape) != lead + (N_SOLVE,):
        raise cuda_build.KernelArgumentError(
            f"K11 takes (..., 8, 8) systems and (..., 8) right-hand sides, got {tuple(A.shape)}, {tuple(b.shape)}")
    flat_a = A.reshape(-1, N_SOLVE, N_SOLVE)
    flat_b = b.reshape(-1, N_SOLVE)
    if A.device.type == "cpu":
        return solve8_plain(flat_a, flat_b).reshape(lead + (N_SOLVE,))
    flat_a, flat_b = _aligned(flat_a.contiguous()), _aligned(flat_b.contiguous())
    cuda_build.require_cuda_tensor("A", flat_a, torch.float32, 3)
    cuda_build.require_cuda_tensor("b", flat_b, torch.float32, 2)
    n = flat_a.shape[0]
    if not 1 <= n < 2**31 or flat_b.device != flat_a.device:
        raise cuda_build.KernelArgumentError(f"K11 takes 1 <= N < 2**31 systems on one device, got {n}")
    x = torch.empty((n, N_SOLVE), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = cuda_build.library().cvst_solve8(
            flat_a.data_ptr(), flat_b.data_ptr(), x.data_ptr(), n, cuda_build.current_stream(A.device))
        cuda_build.check_launch(err, "solve8")
        cuda_build.LAUNCHES["solve8"] += 1
    return x.reshape(lead + (N_SOLVE,))


def four_point_systems(p: torch.Tensor, q: torch.Tensor):
    """The 4-point systems of p, q (..., 4, 2) float32 as torch builds
    them (module docstring): (A + 1e-12 I (..., 8, 8), b (..., 8))."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)
    return A + RIDGE * torch.eye(N_SOLVE, dtype=A.dtype, device=A.device), torch.cat([u, v], dim=-1)


def homography_4pt_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11's 4-point entry: p, q (..., 4, 2)
    float32 -> (..., 3, 3), ``four_point_systems`` solved by
    ``solve8_plain``, h22 = 1."""
    A, b = four_point_systems(p, q)
    h = solve8_plain(A.reshape(-1, N_SOLVE, N_SOLVE), b.reshape(-1, N_SOLVE)).reshape(b.shape)
    H = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return H.reshape(*H.shape[:-1], 3, 3)


def solve_homography_4pt(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The homography (h22 = 1) through each set of four correspondences
    p -> q, (..., 4, 2) float32 each -> (..., 3, 3) (module docstring); a
    singular system (a repeated point) gives non-finite entries.

    CUDA tensors launch K11's 4-point entry; CPU tensors take the plain
    version."""
    lead = tuple(p.shape[:-2])
    if p.shape[-2:] != (4, 2) or q.shape != p.shape:
        raise cuda_build.KernelArgumentError(
            f"K11's 4-point entry takes (..., 4, 2) points p and q, got {tuple(p.shape)}, {tuple(q.shape)}")
    if p.device.type == "cpu":
        return homography_4pt_plain(p, q)
    flat_p = _aligned(p.reshape(-1, 4, 2).contiguous())
    flat_q = _aligned(q.reshape(-1, 4, 2).contiguous())
    cuda_build.require_cuda_tensor("p", flat_p, torch.float32, 3)
    cuda_build.require_cuda_tensor("q", flat_q, torch.float32, 3)
    n = flat_p.shape[0]
    if not 1 <= n < 2**31 or flat_q.device != flat_p.device:
        raise cuda_build.KernelArgumentError(f"K11's 4-point entry takes 1 <= N < 2**31 sets on one device, got {n}")
    H = torch.empty((n, 9), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = cuda_build.library().cvst_homography_4pt(
            flat_p.data_ptr(), flat_q.data_ptr(), H.data_ptr(), n, cuda_build.current_stream(p.device))
        cuda_build.check_launch(err, "homography_4pt")
        cuda_build.LAUNCHES["homography_4pt"] += 1
    return H.reshape(lead + (3, 3))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels' staged loads read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
