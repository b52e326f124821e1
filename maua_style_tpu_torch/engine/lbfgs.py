"""L-BFGS with torch.optim.LBFGS step semantics, and Adam equal to
``optax.adam`` (JAX counterpart: maua_style_tpu/engine/lbfgs.py).

The reference's default optimiser is torch's closure-based L-BFGS with no
line search (optim.py:180-190).  Per iteration:

1. first iteration: d = -g, t = min(1, 1 / ||g||_1) * lr
2. otherwise: y = g - g_prev, s = t_prev * d_prev; if y.s > 1e-10 push
   (s, y) into a bounded circular history and set H0 = y.s / y.y
3. d = -H g from the history; t = lr
4. p <- p + t * d

Unlike ``torch.optim.LBFGS``, nothing here reads a value back to the host:
the insert decision, the circular pointer and the first-step scale stay on
the device as masked writes and ``torch.where`` selects (the reference's
per-iteration ``.item()``, optim.py:210, is what the JAX package removed).

Both optimisers are functional: ``init(p) -> state`` and
``update(g, state) -> (update, state)``, with ``state`` a dict of tensors
(so run-state checkpoints are a plain ``torch.save``).  L-BFGS writes its
(m, N) history rows in place — at 1448² and m = 100 the two histories hold
5 GB, and a functional copy per step would double that.

``method``: ``compact`` (Byrd-Nocedal-Schnabel: one projection pass and
one recombination pass over each history buffer, then m x m algebra) or
``two_loop`` (the classic recursion).  ``history_dtype=torch.bfloat16``
stores the histories in bf16; every dot with them accumulates in f32.
"""

from __future__ import annotations

import torch

_BLOCK = 16  # history rows widened to f32 at a time for bf16 dots


def _project(a: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """(K, N) vectors against (m, N) history rows -> (K, m) f32."""
    if hist.dtype == torch.float32:
        return a.float() @ hist.T
    a = a.to(hist.dtype).float()
    return torch.cat([a @ hist[i : i + _BLOCK].float().T for i in range(0, hist.shape[0], _BLOCK)], dim=1)


def _recombine(coeff: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """sum_m coeff[m] * hist[m] -> (N,) f32."""
    if hist.dtype == torch.float32:
        return coeff @ hist
    coeff = coeff.to(hist.dtype).float()
    out = torch.zeros(hist.shape[1], dtype=torch.float32, device=hist.device)
    for i in range(0, hist.shape[0], _BLOCK):
        out += coeff[i : i + _BLOCK] @ hist[i : i + _BLOCK].float()
    return out


def _row(hist: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return hist.index_select(0, slot.view(1))[0]


class LBFGS:
    def __init__(self, learning_rate: float = 1.0, history_size: int = 100, method: str = "compact", history_dtype=None):
        if method not in ("compact", "two_loop"):
            raise ValueError(method)
        self.lr = float(learning_rate)
        self.m = int(history_size)
        self.method = method
        self.history_dtype = history_dtype

    def init(self, params: torch.Tensor) -> dict[str, torch.Tensor]:
        m, n, dev = self.m, params.numel(), params.device
        hdt = self.history_dtype or params.dtype

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "s_hist": z(m, n, dtype=hdt),
            "y_hist": z(m, n, dtype=hdt),
            "rho": z(m),  # two_loop
            "w_sy": z(m, m),  # SᵀY, absolute slots (compact)
            "w_yy": z(m, m),  # YᵀY, absolute slots (compact)
            "proj": z(2, m),  # (Sᵀg, Yᵀg) for the current g (compact)
            "count": z(dtype=torch.int64),
            "ptr": z(dtype=torch.int64),
            "prev_grad": z(n, dtype=params.dtype),
            "prev_d": z(n, dtype=params.dtype),
            "prev_t": z(),
            "h_diag": torch.ones((), device=dev),
            "step": z(dtype=torch.int64),
        }

    def update(self, g: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        m = self.m
        gf = g.reshape(-1)
        y = gf - state["prev_grad"]
        s = (state["prev_d"] * state["prev_t"]).to(gf.dtype)

        # one pass per history buffer: [s, y, g] against both histories, and
        # against themselves (ys, yy, s·g, y·g)
        a = torch.stack([s, y, gf])
        p_s = _project(a, state["s_hist"])  # (3, m)
        p_y = _project(a, state["y_hist"])  # (3, m)
        gram3 = a.float() @ a.float().T
        ys, yy, sg, yg = gram3[0, 1], gram3[1, 1], gram3[0, 2], gram3[1, 2]

        ok = ys > 1e-10
        okf = ok.float()
        k = state["ptr"].view(1)

        # masked row write at slot k: the old row stays when not inserting
        for name, row in (("s_hist", s), ("y_hist", y)):
            hist = state[name]
            old = hist.index_select(0, k)[0]
            hist.index_copy_(0, k, (okf * row + (1 - okf) * old).to(hist.dtype)[None])

        # patch slot k of the projections: the stale row was replaced
        sy_row = p_y[0].index_copy(0, k, ys.view(1))  # s · Y
        sy_col = p_s[1].index_copy(0, k, ys.view(1))  # Sᵀ y
        yy_col = p_y[1].index_copy(0, k, yy.view(1))  # Yᵀ y
        w_sy = state["w_sy"].index_copy(0, k, sy_row[None]).index_copy(1, k, sy_col[:, None])
        w_yy = state["w_yy"].index_copy(0, k, yy_col[None]).index_copy(1, k, yy_col[:, None])
        proj_ins = torch.stack([p_s[2].index_copy(0, k, sg.view(1)), p_y[2].index_copy(0, k, yg.view(1))])
        proj_keep = torch.stack([p_s[2], p_y[2]])

        state = dict(state)
        state.update(
            rho=torch.where(ok, state["rho"].index_copy(0, k, (1.0 / ys).view(1)), state["rho"]),
            w_sy=torch.where(ok, w_sy, state["w_sy"]),
            w_yy=torch.where(ok, w_yy, state["w_yy"]),
            proj=torch.where(ok, proj_ins, proj_keep),
            ptr=torch.where(ok, (state["ptr"] + 1) % m, state["ptr"]),
            count=torch.where(ok, torch.clamp(state["count"] + 1, max=m), state["count"]),
            h_diag=torch.where(ok, ys / yy, state["h_diag"]),
        )

        hg = _compact_hg(state, gf, m) if self.method == "compact" else _two_loop_hg(state, gf, m)
        d = (-hg).to(gf.dtype)

        g_l1 = gf.abs().sum(dtype=torch.float32)
        lr = torch.full((), self.lr, device=gf.device)
        t = torch.where(state["step"] == 0, torch.clamp(1.0 / g_l1, max=1.0) * self.lr, lr)

        state.update(prev_grad=gf, prev_d=d, prev_t=t, step=state["step"] + 1)
        return (t * d).to(g.dtype).reshape(g.shape), state


def _two_loop_hg(state: dict, g: torch.Tensor, m: int) -> torch.Tensor:
    """H g by the classic two-loop recursion over the valid slots."""
    count, ptr, rho = state["count"], state["ptr"], state["rho"]
    q = -g
    al = torch.zeros(m, device=g.device)
    for j in range(m):  # newest -> oldest
        slot = (ptr - 1 - j) % m
        valid = j < count
        s_j, y_j = _row(state["s_hist"], slot), _row(state["y_hist"], slot)
        a_j = _row(rho, slot) * torch.sum(s_j * q, dtype=torch.float32)
        q = torch.where(valid, q - (a_j * y_j).to(q.dtype), q)
        al = al.index_copy(0, slot.view(1), torch.where(valid, a_j, 0.0).view(1))
    d = (q * state["h_diag"]).to(q.dtype)
    for j in range(m):  # oldest -> newest
        slot = (ptr - count + j) % m
        valid = j < count
        s_j, y_j = _row(state["s_hist"], slot), _row(state["y_hist"], slot)
        be = _row(rho, slot) * torch.sum(y_j * d, dtype=torch.float32)
        d = torch.where(valid, d + (s_j * (_row(al, slot) - be)).to(d.dtype), d)
    return -d  # the loops computed -H g


def _compact_hg(state: dict, g: torch.Tensor, m: int) -> torch.Tensor:
    """H g via the compact representation (algebraically the two-loop result):
    H g = γ g + S w − γ Y u with u = R⁻¹ Sᵀg and
    w = R⁻ᵀ((D + γYᵀY)u − γYᵀg), R = triu(SᵀY), D = diag(SᵀY)."""
    gamma = state["h_diag"]
    # chronological order of the circular slots, oldest first; the first
    # m - count entries are stale and masked out
    j = torch.arange(m, device=g.device)
    ord_ = (state["ptr"] - m + j) % m
    valid = j >= (m - state["count"])

    vmask = valid[:, None] & valid[None, :]
    sy = torch.where(vmask, state["w_sy"][ord_][:, ord_], 0.0)
    yy = torch.where(vmask, state["w_yy"][ord_][:, ord_], 0.0)

    r = torch.triu(sy) + torch.diag(torch.where(valid, 0.0, 1.0))  # identity rows for stale slots
    dvec = torch.diagonal(sy)
    p1 = torch.where(valid, state["proj"][0][ord_], 0.0)
    p2 = torch.where(valid, state["proj"][1][ord_], 0.0)

    u = torch.linalg.solve_triangular(r, p1[:, None], upper=True)[:, 0]
    rhs = dvec * u + gamma * (yy @ u) - gamma * p2
    w = torch.linalg.solve_triangular(r.T, rhs[:, None], upper=False)[:, 0]
    u = torch.where(valid, u, 0.0)
    w = torch.where(valid, w, 0.0)

    # chronological coefficients back to absolute slots; one matvec per buffer
    coeff_s = torch.zeros(m, device=g.device).scatter(0, ord_, w)
    coeff_y = torch.zeros(m, device=g.device).scatter(0, ord_, -gamma * u)
    return gamma * g + _recombine(coeff_s, state["s_hist"]) + _recombine(coeff_y, state["y_hist"])


class Adam:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), step for step."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = float(learning_rate), b1, b2, eps

    def init(self, params: torch.Tensor) -> dict[str, torch.Tensor]:
        return {
            "mu": torch.zeros_like(params),
            "nu": torch.zeros_like(params),
            "count": torch.zeros((), dtype=torch.int64, device=params.device),
        }

    def update(self, g: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        mu = (1 - self.b1) * g + self.b1 * state["mu"]
        nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
        count = state["count"] + 1
        c = count.float()
        mu_hat = mu / (1 - self.b1**c)
        nu_hat = nu / (1 - self.b2**c)
        upd = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return upd, {"mu": mu, "nu": nu, "count": count}


__all__ = ["LBFGS", "Adam"]
