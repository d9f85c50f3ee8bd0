"""Plain PyTorch reference of the moving-PML sweeping preconditioner over a
stride-compressed stack of corner inverses (configuration `c1_f1-n2047`).

Written from Engquist and Ying, "Sweeping preconditioner for the Helmholtz
equation: moving perfectly matched layers", Multiscale Model. Simul. 9(2),
2011, Algorithms 2.3 and 2.4, as the report's code runs them
(https://github.com/bocchs/helmholtz-preconditioner, code.py:11-115 and
:223-385), in their corrected form: the diagonal step replaces u_j by
G_j u_j, and H_F is the whole leading b n x b n block of A.  It imports
torch and the standard library only, nothing of the program, and computes
in complex128 on any device.  The cells' `correct` does not rest on it:
`check.py` judges them by `reference/helmholtz.py`'s NumPy true residual.

* The operator A: the 5-point PML discretization of `reference/helmholtz.py`
  (sigma1 two-sided in x1, sigma2 at the bottom only, Dirichlet at the top,
  the velocity c1 or c2 at the stencil point) and its source f1.
* The subgrid H_j whose top layer is grid row j (0-based, j >= b) spans the
  b rows j-b+1..j with its PML moved up to them: the x2 stretching is
  sigma2's at the local height l h, l = 1..b, the velocity each row's own,
  Dirichlet all round.
* Its corner inverse G_j, the top layer's block of H_j^{-1}, is S_b^{-1} of
  the layer Schur recursion S_1 = H_11, S_l = H_ll - C_{l,l-1} S_{l-1}^{-1}
  C_{l-1,l}, each S_l inverted densely by `torch.linalg.inv`.
* Compression at stride s: G_j is factored only at the sweep steps
  k = j - b = 0, s, 2s, ... and at the last step, and between two samples it
  is their linear interpolation at the step's share of the distance.  This
  is the port's approximation, not the paper's, which factors every
  subgrid (stride 1).
* The apply (Algorithm 2.4), u = f: u_F = T_F f_F by block Thomas over the
  exact Schur inverses of H_F; u_b -= A_{b,b-1} (T_F f_F)_{b-1}; forward,
  j = b+1..n-1: u_j -= A_{j,j-1} G_{j-1} u_{j-1}; diagonal, j = b..n-1:
  u_j = G_j u_j; backward, j = n-2..b: u_j -= G_j A_{j,j+1} u_{j+1}; last
  u_F = T_F (f_F - A_{F,b} u_b).

Layout as in `reference/helmholtz.py`: a grid is (n, n) with [row, col] the
value at (x1 = (col+1) h, x2 = (row+1) h); a batch of grids is (K, n, n).
The five coefficient fields (cc, cw, ce, cs, cn) of a band of rows are
(..., rows, n): cw / ce couple a point to its left / right neighbour,
cs / cn to the row below / above.
"""

import bisect
import dataclasses
import math

import torch

CD = torch.complex128
RD = torch.float64


def sigma(x, const: float, eta: float, two_sided: bool):
    """The quadratic damping profile: PML at x <= eta, and with
    `two_sided` at x >= 1 - eta too (where the two overlap, the first)."""
    amp = const / eta
    out = torch.zeros_like(x)
    if two_sided:
        out = torch.where(x >= 1.0 - eta, amp * ((x - 1.0 + eta) / eta) ** 2,
                          out)
    return torch.where(x <= eta, amp * ((x - eta) / eta) ** 2, out)


def stretch(sig, omega: complex):
    return 1.0 / (1.0 + 1j * sig.to(CD) / omega)


def velocity(medium: str, x, y):
    """c1: the converging lens; c2: the wave-guiding channel."""
    if medium == "c1":
        return 4.0 / 3.0 * (1.0 - 0.5 * torch.exp(
            -32.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)))
    if medium == "c2":
        return 4.0 / 3.0 * (1.0 - 0.5 * torch.exp(-32.0 * (x - 0.5) ** 2))
    raise ValueError(f"unknown medium {medium!r}")


def omega_of(wave_num: float, alpha: float) -> complex:
    return complex(2.0 * math.pi * wave_num, alpha)


def band_fields(n: int, b: int, const: float, omega: complex, medium: str,
                x2, s2_at, device) -> tuple:
    """The unmasked fields of the rows at heights x2 (any shape; the
    velocity is taken there), with the x2 stretching taken at the heights
    `s2_at` (the same shape): each field x2.shape + (n,)."""
    h = 1.0 / (n + 1)
    eta = b * h
    x1 = torch.arange(1, n + 1, dtype=RD, device=device) * h
    s1 = [stretch(sigma(x1 + d, const, eta, True), omega)
          for d in (-0.5 * h, 0.0, 0.5 * h)]
    s2 = [stretch(sigma(s2_at + d, const, eta, False), omega)[..., None]
          for d in (-0.5 * h, 0.0, 0.5 * h)]
    inv_h2 = 1.0 / (h * h)
    cw = inv_h2 * s1[0] / s2[1]
    ce = inv_h2 * s1[2] / s2[1]
    cs = inv_h2 * s2[0] / s1[1]
    cn = inv_h2 * s2[2] / s1[1]
    c = velocity(medium, x1, x2[..., None])
    cc = omega ** 2 / (s1[1] * s2[1] * c ** 2) - (cw + ce + cs + cn)
    return cc, cw, ce, cs, cn


def _dirichlet(fields) -> tuple:
    """Zero the couplings that leave the band: left of the first column,
    right of the last, below the first row and above the last."""
    cc, cw, ce, cs, cn = (f.clone() for f in fields)
    cw[..., 0] = 0
    ce[..., -1] = 0
    cs[..., 0, :] = 0
    cn[..., -1, :] = 0
    return cc, cw, ce, cs, cn


def operator(n: int, b: int, const: float, omega: complex, medium: str,
             device="cpu") -> tuple:
    """The fields (n, n) of A."""
    x2 = torch.arange(1, n + 1, dtype=RD, device=device) / (n + 1)
    return _dirichlet(band_fields(n, b, const, omega, medium, x2, x2, device))


def subgrid_fields(n: int, b: int, const: float, omega: complex, medium: str,
                   tops, device="cpu") -> tuple:
    """The fields (len(tops), b, n) of the subgrids H_j, j in `tops`."""
    h = 1.0 / (n + 1)
    tops = torch.as_tensor(tops, device=device)
    local = torch.arange(1, b + 1, device=device)
    rows = tops[:, None] - b + local                   # 0-based grid rows
    x2 = (rows + 1).to(RD) * h
    s2_at = (local.to(RD) * h).expand_as(x2)
    return _dirichlet(band_fields(n, b, const, omega, medium, x2, s2_at,
                                  device))


def source_f1(n: int, omega: complex, x: float, y: float, device="cpu"):
    """Gaussian point source exp(-(4 omega / pi)^2 r^2) at (x, y)."""
    k = torch.arange(1, n + 1, dtype=RD, device=device) / (n + 1)
    r2 = (k[None, :] - x) ** 2 + (k[:, None] - y) ** 2
    return torch.exp(-((4.0 * omega / math.pi) ** 2) * r2.to(CD))


def apply_operator(fields, U):
    """A U for a batch of grids U (K, n, n)."""
    cc, cw, ce, cs, cn = fields
    Y = cc * U
    Y[..., 1:] += cw[:, 1:] * U[..., :-1]
    Y[..., :-1] += ce[:, :-1] * U[..., 1:]
    Y[..., 1:, :] += cs[1:] * U[..., :-1, :]
    Y[..., :-1, :] += cn[:-1] * U[..., 1:, :]
    return Y


def dense_matrix(fields):
    """The dense (L n, L n) matrix of a band's fields (L, n), unknowns
    ordered row by row."""
    cc, cw, ce, cs, cn = fields
    L, n = cc.shape
    X = torch.zeros((L * n, L * n), dtype=CD, device=cc.device)
    for l in range(L):
        X[l * n:(l + 1) * n, l * n:(l + 1) * n] = _tridiag(cw[l], cc[l],
                                                           ce[l])
        if l > 0:
            X[l * n:(l + 1) * n, (l - 1) * n:l * n] = torch.diag(cs[l])
        if l < L - 1:
            X[l * n:(l + 1) * n, (l + 1) * n:(l + 2) * n] = torch.diag(cn[l])
    return X


def _tridiag(cw, cc, ce):
    """Dense (..., n, n) with sub-diagonal cw[1:], diagonal cc and
    super-diagonal ce[:-1]."""
    X = torch.diag_embed(cc)
    X.diagonal(offset=-1, dim1=-2, dim2=-1).add_(cw[..., 1:])
    X.diagonal(offset=1, dim1=-2, dim2=-1).add_(ce[..., :-1])
    return X


def schur_inverses(fields, keep_all: bool = False):
    """T_l = S_l^{-1} of the layer Schur recursion of a band's fields
    (..., L, n): the stack (..., L, n, n) with `keep_all`, else the last,
    T_{L-1} (..., n, n), which is the corner block of the band's inverse."""
    cc, cw, ce, cs, cn = fields
    L = cc.shape[-2]
    T = torch.linalg.inv(_tridiag(cw[..., 0, :], cc[..., 0, :],
                                  ce[..., 0, :]))
    Ts = [T]
    for l in range(1, L):
        S = _tridiag(cw[..., l, :], cc[..., l, :], ce[..., l, :])
        S -= cs[..., l, :, None] * T * cn[..., l - 1, None, :]
        T = torch.linalg.inv(S)
        del S
        if keep_all:
            Ts.append(T)
    return torch.stack(Ts, dim=-3) if keep_all else T


def sample_steps(M: int, stride: int) -> list:
    """The sweep steps factored at `stride`: 0, stride, 2 stride, ... and
    the last, M - 1."""
    steps = list(range(0, M, stride))
    return steps if steps[-1] == M - 1 else steps + [M - 1]


def _rows(G, V):
    """G v for each row v of V (K, n)."""
    return V @ G.transpose(-1, -2)


@dataclasses.dataclass
class Sweeping:
    """The factored preconditioner: A's fields, H_F's Schur inverses TF
    (b, n, n), and the corner inverses G (len(steps), n, n) of the sweep
    steps `steps`."""
    n: int
    b: int
    A: tuple
    TF: torch.Tensor
    G: torch.Tensor
    steps: list

    def g(self, k: int, V):
        """G_k v for the rows V (K, n) at sweep step k: a sample's product,
        or the interpolation of the two samples' that bracket k."""
        i = bisect.bisect_right(self.steps, k) - 1
        if self.steps[i] == k:
            return _rows(self.G[i], V)
        lo, hi = self.steps[i], self.steps[i + 1]
        t = (k - lo) / (hi - lo)
        return (1.0 - t) * _rows(self.G[i], V) + t * _rows(self.G[i + 1], V)

    def _thomas(self, R):
        """H_F^{-1} R for R (K, b, n), by block Thomas over TF."""
        b = self.b
        cs, cn = self.A[3][:b], self.A[4][:b]
        y = R.clone()
        for l in range(1, b):
            y[:, l] -= cs[l] * _rows(self.TF[l - 1], y[:, l - 1])
        u = torch.empty_like(R)
        u[:, b - 1] = _rows(self.TF[b - 1], y[:, b - 1])
        for l in range(b - 2, -1, -1):
            u[:, l] = _rows(self.TF[l], y[:, l] - cn[l] * u[:, l + 1])
        return u

    def apply(self, F):
        """The preconditioner on a batch of grids F (K, n, n)."""
        n, b = self.n, self.b
        cs, cn = self.A[3], self.A[4]
        u = F.to(CD).clone()
        tf_f = self._thomas(u[:, :b])
        u[:, b] -= cs[b] * tf_f[:, b - 1]
        for j in range(b + 1, n):
            u[:, j] -= cs[j] * self.g(j - 1 - b, u[:, j - 1])
        for j in range(b, n):
            u[:, j] = self.g(j - b, u[:, j])
        for j in range(n - 2, b - 1, -1):
            u[:, j] -= self.g(j - b, cn[j] * u[:, j + 1])
        r = torch.zeros_like(tf_f)
        r[:, b - 1] = cn[b - 1] * u[:, b]
        u[:, :b] = tf_f - self._thomas(r)
        return u


def stored(P: Sweeping, dtype, chunk: int = 16) -> Sweeping:
    """The same preconditioner with its corner inverses stored as two real
    planes of `dtype` (float32, bfloat16, a float8 type), each panel scaled
    by the power of two at its largest magnitude, as a program that keeps G
    in that type would hold it; everything else stays complex128."""
    G = torch.empty_like(P.G)
    for i in range(0, G.shape[0], chunk):
        g = P.G[i:i + chunk]
        amax = g.abs().amax(dim=(-2, -1), keepdim=True)
        scale = torch.exp2(torch.ceil(torch.log2(amax)))
        G[i:i + chunk] = torch.complex(
            (g.real / scale).to(dtype).to(RD) * scale,
            (g.imag / scale).to(dtype).to(RD) * scale)
    return dataclasses.replace(P, G=G)


def factor(n: int, b: int, const: float, omega: complex, medium: str, *,
           stride: int = 1, chunk: int = 16, device="cpu") -> Sweeping:
    """Algorithm 2.3 at `stride`: H_F's Schur inverses and the corner
    inverses of the sampled subgrids, `chunk` subgrids at a time."""
    A = operator(n, b, const, omega, medium, device)
    band = tuple(f[:b].clone() for f in A)
    band[4][b - 1] = 0                       # H_F: no coupling out of row b-1
    TF = schur_inverses(band, keep_all=True)
    steps = sample_steps(n - b, stride)
    G = torch.empty((len(steps), n, n), dtype=CD, device=device)
    for i0 in range(0, len(steps), chunk):
        tops = [b + k for k in steps[i0:i0 + chunk]]
        G[i0:i0 + len(tops)] = schur_inverses(subgrid_fields(
            n, b, const, omega, medium, tops, device))
    return Sweeping(n, b, A, TF, G, steps)


def true_residuals(fields, U, F) -> list:
    """||A u_k - f_k|| / ||f_k|| for the grids U, F (K, n, n)."""
    R = apply_operator(fields, U.to(CD)) - F.to(CD)
    return (torch.linalg.vector_norm(R, dim=(-2, -1))
            / torch.linalg.vector_norm(F.to(CD), dim=(-2, -1))).tolist()
