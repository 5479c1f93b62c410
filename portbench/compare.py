"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to its limit from ``limits/<cell>.json``."""

from __future__ import annotations

import math

import torch


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def em_numbers(jobs_lls, lls_r, jobs_th, th_r: dict, detail: bool = False) -> dict:
    """EM jobs of the program against the reference's one job from the same
    start.  ``jobs_lls``: each job's logliks (a job cut by the window's end
    gives its first ones); ``loglik_1`` is the worst relative gap of a
    job's first loglik, ``loglik`` of any.  ``jobs_th``: for each kept job
    {k: {leaf: tensor}} after k = 0, 1, 3 and the last M-step, as ``th_r``;
    ``change_1``, ``change_3`` and ``change_last`` are the worst leaf's gap
    between the norms of the parameters' change from the start, against
    the reference's change of that leaf or of the median leaf, whichever is
    larger, worst over the kept jobs.  Leaves the reference moves by less
    than a thousandth of the median leaf's change are left out.  ``detail``
    adds, for the calibration's look, each iteration's worst loglik gap,
    each leaf's gap and the norm of its difference (``diff_k``: the same
    measure with the difference of the two parameters), and the median
    leaf's gap."""
    gaps_by_it: dict = {}
    for lls in jobs_lls:
        for i, (a, b) in enumerate(zip(lls, lls_r)):
            gaps_by_it.setdefault(i, []).append(abs(a - b) / abs(b))
    each = [worst(g) for _, g in sorted(gaps_by_it.items())]
    out = {"loglik": worst(each), "loglik_1": worst(each[:1])}
    if detail:
        out["loglik_each"] = each
    last = max(th_r)
    for k, name in ((1, "change_1"), (3, "change_3"), (last, "change_last")):
        ch_r = {leaf: norm(th_r[k][leaf] - th_r[0][leaf]) for leaf in th_r[0]}
        med = float(torch.tensor(list(ch_r.values())).median())
        gaps, diffs = [], []
        for th_p in jobs_th:
            for leaf, c in ch_r.items():
                if c < 1e-3 * med:
                    continue
                ch_p = norm(th_p[k][leaf].double() - th_p[0][leaf].double())
                den = max(c, med)
                gaps.append(abs(ch_p - c) / den)
                if detail:
                    diffs.append(norm(th_p[k][leaf].double() - th_r[k][leaf]) / den)
                    out[f"leaf_{name}_{leaf}"] = [gaps[-1], diffs[-1]]
        out[name] = worst(gaps)
        if detail:
            out[f"diff_{name}"] = worst(diffs)
            out[f"{name}_median"] = float(torch.tensor(gaps).median())
    return out


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not a number."""
    values = [float(v) for v in values]
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: [value, limit]})."""
    shown = {name: [numbers.get(name, math.inf), lim] for name, lim in limits.items()}
    ok = all(math.isfinite(v) and v <= lim for v, lim in shown.values())
    return ok, shown
