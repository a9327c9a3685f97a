"""The comparison that decides ``correct``: every answer of the window held to
the plain reference, after the window has closed.

For each call the θ is drawn again from (seed, call) and must match the
call's checksum; the reference (``reference/<config>.py``) then works the
residual out again in float64 from θ and the program's x, y and s, and each
lane gets its true KKT error

    max(‖G‖∞, ‖H − s‖∞, ‖s∘y‖∞, max(0, −s), max(0, −y)),

NaN read as infinite. A lane is certified when the program reports it
SOLVED and this error is at most the configuration's tolerance. The numbers
compared, each with its limit from the configuration's ``checks``:

  kkt_max_solved      the largest error of a lane reported SOLVED;
  uncertified_share   the share of all lanes not certified;
  theta_mismatch      calls whose θ drawn again differs (limit 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: The program's status of a solved lane (mcp_tpu_torch.types.SOLVED).
SOLVED = 0
#: Lanes per block of the reference.
BLOCK = 4096


class Verdict(NamedTuple):
    correct: bool
    attempted: int
    certified: int
    numbers: dict  # name -> (value, limit)
    readings: dict  # further statistics of the errors, compared with nothing


def true_kkt(gh, cfg, theta, x, y, s) -> torch.Tensor:
    """Per-lane true KKT error in float64 (see the module docstring)."""
    theta, x, y, s = (t.double() for t in (theta, x, y, s))
    G, H = gh(cfg, theta, x, y)
    parts = [G.abs().amax(1), (H - s).abs().amax(1), (s * y).abs().amax(1),
             (-s).clamp_min(0).amax(1), (-y).clamp_min(0).amax(1)]
    err = torch.stack(parts, 1).amax(1)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


def judge(session, window, loop, reference) -> Verdict:
    cfg = session.cfg
    tol = cfg["solver"]["tol"]
    limits = dict(cfg["checks"])
    device = session.device
    attempted = certified = mismatched = 0
    worst_solved, errors = 0.0, []
    for call in window.calls:
        theta = loop.redraw(session, call)
        if float(theta.double().sum()) != call.checksum:
            mismatched += 1
        a = call.answer
        for lo in range(0, a.x.shape[0], BLOCK):
            hi = lo + BLOCK
            err = true_kkt(reference.gh, cfg, theta[lo:hi],
                           *(t[lo:hi].to(device) for t in (a.x, a.y, a.s)))
            solved = a.status[lo:hi].to(device) == SOLVED
            errors.append(err.float().cpu())
            attempted += int(err.numel())
            certified += int((solved & (err <= tol)).sum())
            if bool(solved.any()):
                worst_solved = max(worst_solved, float(err[solved].max()))
        del theta
    numbers = {
        "kkt_max_solved": (worst_solved, limits.pop("kkt_max_solved")),
        "uncertified_share": (1.0 - certified / max(attempted, 1),
                              limits.pop("uncertified_share")),
        "theta_mismatch": (mismatched, 0),
    }
    if limits:
        raise KeyError(f"checks {sorted(limits)} of the configuration are not known")
    correct = attempted > 0 and all(v <= lim for v, lim in numbers.values())
    return Verdict(correct, attempted, certified, numbers, readings(errors))


def readings(errors) -> dict:
    """Quantiles of every lane's error, and the share above the tolerance's
    tenth, for the record."""
    if not errors:
        return {}
    e = torch.cat(errors).double().clamp_max(1e30)
    q = torch.quantile(e[:2**24], torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return {"kkt_p50": float(q[0]), "kkt_p90": float(q[1]), "kkt_p99": float(q[2])}
