"""``compile_model`` — the paper's §4 verification protocol as the front
door of the serving stack.

The paper validates the Maclaurin approximation before deploying it by
scoring sample data against the exact model. ``compile_model`` runs that
protocol across every registered family and dtype: compile each
candidate, measure its error against the exact expansion (kernel B2 on
the card) and its serving latency on the artifact's device, and return
the cheapest artifact whose error meets the budget. The full report
ships in the winner's meta (``compile_report``), so the decision can be
audited from the artifact file alone. It behaves as
``repro.core.families.compile_model`` does, row for row; only the
latency (measured) and the cost prior's constants (the H100's) differ.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend
from repro_torch.core.families.base import CompiledArtifact, as_batch, stack_heads
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import autotune


@dataclasses.dataclass(frozen=True)
class Budget:
    """The accuracy envelope a servable artifact must meet.

    ``max_err`` bounds the chosen error ``metric`` ("mean_abs" or
    "max_abs") of family scores against the exact expansion on the
    verification sample. ``relative=True`` scales the bound by the mean
    |exact score|. ``min_valid`` (optional) also requires the candidate's
    validity verdict to cover at least that fraction of the sample rows,
    so a caller who needs fast-path coverage skips an artifact that is
    accurate but would send every row to the exact path.
    """

    max_err: float
    metric: str = "mean_abs"
    relative: bool = False
    min_valid: float | None = None

    def __post_init__(self):
        if self.metric not in ("mean_abs", "max_abs"):
            raise ValueError(f"unknown budget metric {self.metric!r}")
        if self.min_valid is not None and not 0.0 <= self.min_valid <= 1.0:
            raise ValueError(f"min_valid must be in [0, 1], got {self.min_valid}")

    def limit(self, exact_scale: float) -> float:
        return self.max_err * (exact_scale if self.relative else 1.0)


def compile_model(
    svm: SVMModel,
    budget: Budget,
    *,
    sample=None,
    sample_n: int = 256,
    families: tuple[str, ...] | None = None,
    dtypes: tuple[str, ...] = ("float32", "int8"),
    seed: int = 0,
    family_opts: dict | None = None,
    timing_repeats: int = 5,
    cost_margin: float | None = 4.0,
) -> CompiledArtifact:
    """Compile ``svm`` under every (family, dtype) candidate and return
    the fastest artifact meeting ``budget`` on the verification sample.

    Each family is compiled at every entry of ``dtypes``; the combined
    error of an int8 candidate against the exact expansion is what the
    budget gates. ``sample=None`` draws held-out points around the SVs
    (``fourier.holdout_sample``, from ``seed``). ``family_opts`` maps a
    family name to extra compile options; a combination a family rejects
    with ``NotImplementedError`` is skipped and noted in the report, so
    the report has a row (measured, pruned or skipped) for every (family,
    dtype) cell. Raises ``ValueError`` listing every measured error when
    no candidate fits the budget.

    ``cost_margin`` prunes by the analytic prior
    (``repro_torch.launch.roofline.family_candidate_seconds``): once some
    measured candidate meets the budget, a later candidate whose predicted
    cost exceeds ``cost_margin`` times the cheapest predicted cost of the
    budget-meeting candidates so far is skipped without compiling or
    timing it. Predictions are compared only with predictions, never with
    measured times; a candidate the prior cannot model is always
    measured. ``cost_margin=None`` measures every candidate.
    """
    from repro_torch.core import families as _families
    from repro_torch.core.families import quantize
    from repro_torch.launch import roofline

    names = families or tuple(_families.FAMILIES)
    for dt in dtypes:
        quantize.check_dtype(dt)
    opts = family_opts or {}
    dev = svm.X.device

    if sample is None:
        sample = _families.fourier.holdout_sample(svm, seed, sample_n)
    Z = as_batch(sample, dev)

    ay2, b, k_heads, _ = stack_heads(svm)
    X = svm.X.to(torch.float32).contiguous()
    ay2 = ay2.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    exact = backend.rbf_scores(Z, X, ay2, svm.gamma, b)  # (n, K)
    exact_scale = float(exact.abs().mean())
    limit = budget.limit(exact_scale)

    n_sample, d_in = int(Z.shape[0]), int(Z.shape[1])
    best_predicted: float | None = None  # cheapest predicted cost among
    report = []  # budget-meeting measured candidates
    candidates: list[tuple[float, CompiledArtifact]] = []
    for name in names:
        fam = _families.get_family(name)
        for dt in dtypes:
            predicted = None
            if cost_margin is not None:
                predicted = roofline.family_candidate_seconds(
                    name,
                    dt,
                    n=n_sample,
                    d=d_in,
                    k=int(k_heads),
                    num_features=opts.get(name, {}).get("num_features"),
                    structured=bool(opts.get(name, {}).get("structured")),
                )
            if (
                cost_margin is not None
                and predicted is not None
                and best_predicted is not None
                and predicted > cost_margin * best_predicted
            ):
                report.append(
                    {
                        "family": name,
                        "dtype": dt,
                        "skipped": "pruned_by_cost",
                        "predicted_cost_s": predicted,
                        "meets_budget": False,
                    }
                )
                continue
            # Caller opts override the defaults; the shared sample doubles
            # as the held-out set of every family.
            try:
                kwargs = {"seed": seed, "holdout": Z, "dtype": dt}
                art = fam.compile(svm, **{**kwargs, **opts.get(name, {})})
            except NotImplementedError as e:
                report.append(
                    {
                        "family": name,
                        "dtype": dt,
                        "skipped": str(e),
                        "meets_budget": False,
                    }
                )
                continue
            scores, valid = fam.score(art, Z)
            err = (scores - exact).abs()
            measured = {
                "mean_abs": float(err.mean()),
                "max_abs": float(err.max()),
            }
            # fraction of sample rows the candidate would fast-path
            valid_fraction = float(valid.to(torch.float32).mean())
            latency_ms = 1e3 * autotune.measure(
                lambda _f=fam, _a=art: _f.score(_a, Z)[0],
                repeats=timing_repeats,
                warmup=2,
                device=dev,
            )
            ok = measured[budget.metric] <= limit and (
                budget.min_valid is None or valid_fraction >= budget.min_valid
            )
            row = {
                "family": name,
                "dtype": art.dtype,
                **measured,
                "valid_fraction": round(valid_fraction, 4),
                "latency_ms": round(latency_ms, 4),
                "artifact_bytes": art.nbytes(),
                "meets_budget": ok,
            }
            if predicted is not None:
                row["predicted_cost_s"] = predicted
            for key in ("quant_mean_abs_err", "quant_max_abs_err"):
                if key in art.meta:
                    row[key] = art.meta[key]
            report.append(row)
            if ok:
                candidates.append((latency_ms, art))
                if predicted is not None and (
                    best_predicted is None or predicted < best_predicted
                ):
                    best_predicted = predicted

    if not candidates:
        raise ValueError(
            f"no family meets {budget} (limit {limit:.4g}) on the "
            f"verification sample: "
            + ", ".join(
                f"{r['family']}[{r.get('dtype', '?')}]: "
                + (f"{r[budget.metric]:.4g}" if budget.metric in r else "skipped")
                for r in report
            )
        )
    _, winner = min(candidates, key=lambda t: t[0])
    return winner.with_meta(
        compile_report={
            "budget": dataclasses.asdict(budget),
            "limit": limit,
            "exact_mean_abs_score": exact_scale,
            "sample_n": int(Z.shape[0]),
            "families": report,
            "chosen": winner.family,
            "chosen_dtype": winner.dtype,
        }
    )
