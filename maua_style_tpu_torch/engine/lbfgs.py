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

from ..parallel.spatial import sum_on

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
    tensors either way, with a leading frame dim for ``frames=True``.

    Banded parameters (a list of tensors, one per band of a pastiche on a
    "space" mesh, ``parallel/spatial.py``) are one problem cut into pieces:
    the pastiche-sized entries of the state (``s_hist``, ``y_hist``,
    ``prev_grad``, ``prev_d``) are lists, each piece on its band's device,
    and every dot product with them sums its per-band parts on the first
    band's device, where the m-sized state lives."""

    def __init__(self, learning_rate: float = 1.0, history_size: int = 100, method: str = "compact", history_dtype=None,
                 frames: bool = False):
        if method not in ("compact", "two_loop"):
            raise ValueError(method)
        self.lr = float(learning_rate)
        self.m = int(history_size)
        self.method = method
        self.history_dtype = history_dtype
        self.frames = bool(frames)

    def init(self, params) -> dict:
        banded = isinstance(params, (list, tuple))
        pieces = list(params) if banded else [params]
        b = pieces[0].shape[0] if self.frames else 1
        m, dev = self.m, pieces[0].device
        hdt = self.history_dtype or pieces[0].dtype

        def z(*shape, dtype=torch.float32):
            return torch.zeros((b, *shape), dtype=dtype, device=dev)

        def vec(*shape, dtype):  # one piece per band, on its device
            return [torch.zeros((b, *shape, p.numel() // b), dtype=dtype, device=p.device) for p in pieces]

        state = {
            "s_hist": vec(m, dtype=hdt),
            "y_hist": vec(m, dtype=hdt),
            "rho": z(m),  # two_loop
            "w_sy": z(m, m),  # SᵀY, absolute slots (compact)
            "w_yy": z(m, m),  # YᵀY, absolute slots (compact)
            "proj": z(2, m),  # (Sᵀg, Yᵀg) for the current g (compact)
            "count": z(dtype=torch.int64),
            "ptr": z(dtype=torch.int64),
            "prev_grad": vec(dtype=pieces[0].dtype),
            "prev_d": vec(dtype=pieces[0].dtype),
            "prev_t": z(),
            "h_diag": torch.ones((b,), device=dev),
            "step": z(dtype=torch.int64),
        }
        return self._unwrap(state, banded)

    def _unwrap(self, state: dict, banded: bool) -> dict:
        """The internal layout (a leading frame dim, pieces as lists) ->
        the caller's: no frame dim for one problem, no list unbanded."""
        if not self.frames:
            state = {k: [x[0] for x in v] if isinstance(v, list) else v[0] for k, v in state.items()}
        return state if banded else {k: v[0] if isinstance(v, list) else v for k, v in state.items()}

    def update(self, g, state: dict):
        banded = isinstance(g, (list, tuple))
        pieces = list(g) if banded else [g]
        if not banded:
            state = {k: [state[k]] if k in _PIECES else v for k, v in state.items()}
        if self.frames:
            flat = [x.reshape(x.shape[0], -1) for x in pieces]
        else:  # one problem: a frame dim of 1 as views, so the history rows are still written in place
            flat = [x.reshape(1, -1) for x in pieces]
            state = {k: [x[None] for x in v] if isinstance(v, list) else v[None] for k, v in state.items()}
        upd, state = self._update(flat, state)
        out = [u.to(x.dtype).reshape(x.shape) for u, x in zip(upd, pieces)]
        return (out if banded else out[0]), self._unwrap(state, banded)

    def _update(self, gfs: list, state: dict) -> tuple[list, dict]:
        m = self.m
        dev = gfs[0].device  # the m-sized state's
        rows = torch.arange(gfs[0].shape[0], device=dev)
        y = [g - pg for g, pg in zip(gfs, state["prev_grad"])]
        s = [(pd * state["prev_t"].to(pd.device)[:, None]).to(g.dtype) for pd, g in zip(state["prev_d"], gfs)]

        # one pass per history buffer: [s, y, g] against both histories, and
        # against themselves (ys, yy, s·g, y·g)
        a = [torch.stack(v, dim=1) for v in zip(s, y, gfs)]
        p_s = sum_on(dev, [_project(ai, h) for ai, h in zip(a, state["s_hist"])])  # (B, 3, m)
        p_y = sum_on(dev, [_project(ai, h) for ai, h in zip(a, state["y_hist"])])  # (B, 3, m)
        gram3 = sum_on(dev, [ai.float() @ ai.float().transpose(1, 2) for ai in a])
        ys, yy, sg, yg = gram3[:, 0, 1], gram3[:, 1, 1], gram3[:, 0, 2], gram3[:, 1, 2]

        ok = ys > 1e-10
        k = state["ptr"]

        # masked row write at each frame's slot k: the old row stays where
        # the frame does not insert
        for name, new_rows in (("s_hist", s), ("y_hist", y)):
            for hist, row in zip(state[name], new_rows):
                r, kk, okf = rows.to(hist.device), k.to(hist.device), ok.float().to(hist.device)[:, None]
                old = hist[r, kk]
                hist[r, kk] = (okf * row + (1 - okf) * old).to(hist.dtype)

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

        hg = _compact_hg(state, gfs, m) if self.method == "compact" else _two_loop_hg(state, gfs, m)
        d = [(-h).to(g.dtype) for h, g in zip(hg, gfs)]

        g_l1 = sum_on(dev, [g.abs().sum(dim=1, dtype=torch.float32) for g in gfs])
        t = torch.where(state["step"] == 0, torch.clamp(1.0 / g_l1, max=1.0) * self.lr, self.lr)

        state.update(prev_grad=gfs, prev_d=d, prev_t=t, step=state["step"] + 1)
        return [t.to(di.device)[:, None] * di for di in d], state


# the state's pastiche-sized entries: one piece per band on a "space" mesh
_PIECES = ("s_hist", "y_hist", "prev_grad", "prev_d")


def _two_loop_hg(state: dict, gs: list, m: int) -> list:
    """H g by the classic two-loop recursion over each frame's valid slots,
    piece by piece, each dot product summed over the pieces."""
    count, ptr, rho = state["count"], state["ptr"], state["rho"]
    dev = rho.device
    rows = torch.arange(gs[0].shape[0], device=dev)
    pieces = list(zip(state["s_hist"], state["y_hist"]))
    q = [-g for g in gs]
    al = torch.zeros(rho.shape, device=dev)
    for j in range(m):  # newest -> oldest
        slot = (ptr - 1 - j) % m
        valid = (j < count)[:, None]
        dots = [torch.sum(sh[rows.to(sh.device), slot.to(sh.device)] * qi, dim=1, dtype=torch.float32)
                for (sh, _), qi in zip(pieces, q)]
        a_j = rho[rows, slot] * sum_on(dev, dots)
        q = [torch.where(valid.to(qi.device), qi - (a_j.to(qi.device)[:, None] * yh[rows.to(yh.device), slot.to(yh.device)]).to(qi.dtype), qi)
             for (_, yh), qi in zip(pieces, q)]
        al = al.scatter(1, slot[:, None], torch.where(valid, a_j[:, None], 0.0))
    d = [(qi * state["h_diag"].to(qi.device)[:, None]).to(qi.dtype) for qi in q]
    for j in range(m):  # oldest -> newest
        slot = (ptr - count + j) % m
        valid = (j < count)[:, None]
        dots = [torch.sum(yh[rows.to(yh.device), slot.to(yh.device)] * di, dim=1, dtype=torch.float32)
                for (_, yh), di in zip(pieces, d)]
        coef = al[rows, slot] - rho[rows, slot] * sum_on(dev, dots)
        d = [torch.where(valid.to(di.device), di + (sh[rows.to(sh.device), slot.to(sh.device)] * coef.to(di.device)[:, None]).to(di.dtype), di)
             for (sh, _), di in zip(pieces, d)]
    return [-di for di in d]  # the loops computed -H g


def _compact_hg(state: dict, gs: list, m: int) -> list:
    """H g via the compact representation (algebraically the two-loop result):
    H g = γ g + S w − γ Y u with u = R⁻¹ Sᵀg and
    w = R⁻ᵀ((D + γYᵀY)u − γYᵀg), R = triu(SᵀY), D = diag(SᵀY), per frame;
    the m x m algebra on the state's device, one recombination per piece."""
    gamma = state["h_diag"][:, None]
    dev = gamma.device
    # chronological order of the circular slots, oldest first; the first
    # m - count entries are stale and masked out
    j = torch.arange(m, device=dev)
    ord_ = (state["ptr"][:, None] - m + j) % m
    valid = j >= (m - state["count"][:, None])

    vmask = valid[:, :, None] & valid[:, None, :]
    bi = torch.arange(gs[0].shape[0], device=dev)[:, None, None]
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
    return [gamma.to(g.device) * g + _recombine(coeff_s.to(g.device), sh) + _recombine(coeff_y.to(g.device), yh)
            for g, sh, yh in zip(gs, state["s_hist"], state["y_hist"])]


class Adam:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), step for step.
    Banded parameters (a list, one tensor per band) keep their moments band
    by band; the step count lives with the first band."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = float(learning_rate), b1, b2, eps

    def init(self, params) -> dict:
        banded = isinstance(params, (list, tuple))
        pieces = list(params) if banded else [params]
        mu, nu = [torch.zeros_like(p) for p in pieces], [torch.zeros_like(p) for p in pieces]
        return {
            "mu": mu if banded else mu[0],
            "nu": nu if banded else nu[0],
            "count": torch.zeros((), dtype=torch.int64, device=pieces[0].device),
        }

    def update(self, g, state: dict):
        count = state["count"] + 1
        if isinstance(g, (list, tuple)):
            steps = [self._step(gi, mu, nu, count.to(gi.device)) for gi, mu, nu in zip(g, state["mu"], state["nu"])]
            upd, mu, nu = (list(x) for x in zip(*steps))
        else:
            upd, mu, nu = self._step(g, state["mu"], state["nu"], count)
        return upd, {"mu": mu, "nu": nu, "count": count}

    def _step(self, g, mu, nu, count):
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * (g * g) + self.b2 * nu
        c = count.float()
        mu_hat = mu / (1 - self.b1**c)
        nu_hat = nu / (1 - self.b2**c)
        return -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)), mu, nu


__all__ = ["LBFGS", "Adam"]
