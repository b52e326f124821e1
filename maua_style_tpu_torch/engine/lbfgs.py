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
(so run-state checkpoints are a plain ``torch.save``).  L-BFGS keeps a
leading frame dim throughout: ``LBFGS(frames=True)`` optimises a stack of
independent problems at once (JAX's ``vmap`` over frames), each with its
own state; Adam is elementwise, so a stack is already per-frame.  L-BFGS writes its
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
    """(B, K, N) vectors against (B, m, N) history rows -> (B, K, m) f32."""
    if hist.dtype == torch.float32:
        return a.float() @ hist.transpose(1, 2)
    a = a.to(hist.dtype).float()
    return torch.cat([a @ hist[:, i : i + _BLOCK].float().transpose(1, 2) for i in range(0, hist.shape[1], _BLOCK)], dim=2)


def _recombine(coeff: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """sum_m coeff[b, m] * hist[b, m] -> (B, N) f32."""
    if hist.dtype == torch.float32:
        return (coeff[:, None] @ hist)[:, 0]
    coeff = coeff.to(hist.dtype).float()
    out = torch.zeros(hist.shape[0], hist.shape[2], dtype=torch.float32, device=hist.device)
    for i in range(0, hist.shape[1], _BLOCK):
        out += (coeff[:, None, i : i + _BLOCK] @ hist[:, i : i + _BLOCK].float())[:, 0]
    return out


class LBFGS:
    """``frames=True``: the leading dim of the parameters indexes independent
    problems (vid_img's stacked frames), each with its own history rows,
    circular pointer and count, insert decision, first-step scale and H0;
    otherwise the whole tensor is one problem.  The state is a dict of
    tensors either way, with a leading frame dim for ``frames=True``."""

    def __init__(self, learning_rate: float = 1.0, history_size: int = 100, method: str = "compact", history_dtype=None,
                 frames: bool = False):
        if method not in ("compact", "two_loop"):
            raise ValueError(method)
        self.lr = float(learning_rate)
        self.m = int(history_size)
        self.method = method
        self.history_dtype = history_dtype
        self.frames = bool(frames)

    def init(self, params: torch.Tensor) -> dict[str, torch.Tensor]:
        b = params.shape[0] if self.frames else 1
        m, n, dev = self.m, params.numel() // b, params.device
        hdt = self.history_dtype or params.dtype

        def z(*shape, dtype=torch.float32):
            return torch.zeros((b, *shape), dtype=dtype, device=dev)

        state = {
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
            "h_diag": torch.ones((b,), device=dev),
            "step": z(dtype=torch.int64),
        }
        return state if self.frames else {k: v[0] for k, v in state.items()}

    def update(self, g: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        if self.frames:
            upd, state = self._update(g.reshape(g.shape[0], -1), state)
            return upd.to(g.dtype).reshape(g.shape), state
        # one problem: a frame dim of 1 as views, so the history rows are
        # still written in place
        upd, state = self._update(g.reshape(1, -1), {k: v[None] for k, v in state.items()})
        return upd.to(g.dtype).reshape(g.shape), {k: v[0] for k, v in state.items()}

    def _update(self, gf: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        m = self.m
        rows = torch.arange(gf.shape[0], device=gf.device)
        y = gf - state["prev_grad"]
        s = (state["prev_d"] * state["prev_t"][:, None]).to(gf.dtype)

        # one pass per history buffer: [s, y, g] against both histories, and
        # against themselves (ys, yy, s·g, y·g)
        a = torch.stack([s, y, gf], dim=1)
        p_s = _project(a, state["s_hist"])  # (B, 3, m)
        p_y = _project(a, state["y_hist"])  # (B, 3, m)
        gram3 = a.float() @ a.float().transpose(1, 2)
        ys, yy, sg, yg = gram3[:, 0, 1], gram3[:, 1, 1], gram3[:, 0, 2], gram3[:, 1, 2]

        ok = ys > 1e-10
        okf = ok.float()[:, None]
        k = state["ptr"]

        # masked row write at each frame's slot k: the old row stays where
        # the frame does not insert
        for name, row in (("s_hist", s), ("y_hist", y)):
            hist = state[name]
            old = hist[rows, k]
            hist[rows, k] = (okf * row + (1 - okf) * old).to(hist.dtype)

        def put(v, x):  # v (B, m) with slot k of each frame set to x (B,)
            return v.scatter(1, k[:, None], x[:, None])

        # patch slot k of the projections: the stale row was replaced
        sy_row = put(p_y[:, 0], ys)  # s · Y
        sy_col = put(p_s[:, 1], ys)  # Sᵀ y
        yy_col = put(p_y[:, 1], yy)  # Yᵀ y
        w_sy, w_yy = state["w_sy"].clone(), state["w_yy"].clone()
        w_sy[rows, k], w_yy[rows, k] = sy_row, yy_col
        w_sy[rows, :, k], w_yy[rows, :, k] = sy_col, yy_col
        proj_ins = torch.stack([put(p_s[:, 2], sg), put(p_y[:, 2], yg)], dim=1)
        proj_keep = torch.stack([p_s[:, 2], p_y[:, 2]], dim=1)

        ok1, ok2 = ok[:, None], ok[:, None, None]
        state = dict(state)
        state.update(
            rho=torch.where(ok1, put(state["rho"], 1.0 / ys), state["rho"]),
            w_sy=torch.where(ok2, w_sy, state["w_sy"]),
            w_yy=torch.where(ok2, w_yy, state["w_yy"]),
            proj=torch.where(ok2, proj_ins, proj_keep),
            ptr=torch.where(ok, (k + 1) % m, k),
            count=torch.where(ok, torch.clamp(state["count"] + 1, max=m), state["count"]),
            h_diag=torch.where(ok, ys / yy, state["h_diag"]),
        )

        hg = _compact_hg(state, gf, m) if self.method == "compact" else _two_loop_hg(state, gf, m)
        d = (-hg).to(gf.dtype)

        g_l1 = gf.abs().sum(dim=1, dtype=torch.float32)
        t = torch.where(state["step"] == 0, torch.clamp(1.0 / g_l1, max=1.0) * self.lr, self.lr)

        state.update(prev_grad=gf, prev_d=d, prev_t=t, step=state["step"] + 1)
        return t[:, None] * d, state


def _two_loop_hg(state: dict, g: torch.Tensor, m: int) -> torch.Tensor:
    """H g by the classic two-loop recursion over each frame's valid slots."""
    count, ptr, rho = state["count"], state["ptr"], state["rho"]
    s_hist, y_hist = state["s_hist"], state["y_hist"]
    rows = torch.arange(g.shape[0], device=g.device)
    q = -g
    al = torch.zeros(rho.shape, device=g.device)
    for j in range(m):  # newest -> oldest
        slot = (ptr - 1 - j) % m
        valid = (j < count)[:, None]
        a_j = rho[rows, slot] * torch.sum(s_hist[rows, slot] * q, dim=1, dtype=torch.float32)
        q = torch.where(valid, q - (a_j[:, None] * y_hist[rows, slot]).to(q.dtype), q)
        al = al.scatter(1, slot[:, None], torch.where(valid, a_j[:, None], 0.0))
    d = (q * state["h_diag"][:, None]).to(q.dtype)
    for j in range(m):  # oldest -> newest
        slot = (ptr - count + j) % m
        valid = (j < count)[:, None]
        be = rho[rows, slot] * torch.sum(y_hist[rows, slot] * d, dim=1, dtype=torch.float32)
        d = torch.where(valid, d + (s_hist[rows, slot] * (al[rows, slot] - be)[:, None]).to(d.dtype), d)
    return -d  # the loops computed -H g


def _compact_hg(state: dict, g: torch.Tensor, m: int) -> torch.Tensor:
    """H g via the compact representation (algebraically the two-loop result):
    H g = γ g + S w − γ Y u with u = R⁻¹ Sᵀg and
    w = R⁻ᵀ((D + γYᵀY)u − γYᵀg), R = triu(SᵀY), D = diag(SᵀY), per frame."""
    gamma = state["h_diag"][:, None]
    # chronological order of the circular slots, oldest first; the first
    # m - count entries are stale and masked out
    j = torch.arange(m, device=g.device)
    ord_ = (state["ptr"][:, None] - m + j) % m
    valid = j >= (m - state["count"][:, None])

    vmask = valid[:, :, None] & valid[:, None, :]
    bi = torch.arange(g.shape[0], device=g.device)[:, None, None]
    sy = torch.where(vmask, state["w_sy"][bi, ord_[:, :, None], ord_[:, None, :]], 0.0)
    yy = torch.where(vmask, state["w_yy"][bi, ord_[:, :, None], ord_[:, None, :]], 0.0)

    r = torch.triu(sy) + torch.diag_embed(torch.where(valid, 0.0, 1.0))  # identity rows for stale slots
    dvec = torch.diagonal(sy, dim1=1, dim2=2)
    p1 = torch.where(valid, state["proj"][:, 0].gather(1, ord_), 0.0)
    p2 = torch.where(valid, state["proj"][:, 1].gather(1, ord_), 0.0)

    u = torch.linalg.solve_triangular(r, p1[..., None], upper=True)[..., 0]
    rhs = dvec * u + gamma * (yy @ u[..., None])[..., 0] - gamma * p2
    w = torch.linalg.solve_triangular(r.transpose(1, 2), rhs[..., None], upper=False)[..., 0]
    u = torch.where(valid, u, 0.0)
    w = torch.where(valid, w, 0.0)

    # chronological coefficients back to absolute slots; one product per buffer
    coeff_s = torch.zeros_like(w).scatter(1, ord_, w)
    coeff_y = torch.zeros_like(u).scatter(1, ord_, -gamma * u)
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
