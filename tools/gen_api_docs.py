"""Generate docs/API.md — a markdown reference of the public surface.

The reference ships a sphinx `doc/` tree; this is the rebuild's equivalent:
one generated markdown file covering every public
module, with signatures and first-paragraph docstrings pulled from the
source of truth (the code). Regenerate after API changes:

    JAX_PLATFORMS=cpu python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import sys

sys.path.insert(0, ".")

# (module, [names]) — None means use __all__ or all public callables/classes.
SECTIONS: list[tuple[str, str, list[str] | None]] = [
    ("Top-level API", "psulvsb_tpu", None),
    ("Solver facade & functional API", "psulvsb_tpu.api", None),
    ("Solver configuration", "psulvsb_tpu.solver.config",
     ["SolverParams", "RotationEstimationAlgorithm", "InlierSelectionMode",
      "InlierGraphFormulation"]),
    ("Solution type", "psulvsb_tpu.solver.solution", ["RegistrationSolution"]),
    ("Staged solver", "psulvsb_tpu.solver.psulvsb", ["psulvsb_solve"]),
    ("Fused solver", "psulvsb_tpu.solver.fused", ["psulvsb_register"]),
    ("Basic (classic RANSAC) solvers", "psulvsb_tpu.solver.basic", None),
    ("Classic TEASER pipeline", "psulvsb_tpu.solver.classic", None),
    ("Scalar TLS estimation", "psulvsb_tpu.robust.scalar_tls", None),
    ("Scale solvers", "psulvsb_tpu.robust.scale", None),
    ("Translation solver", "psulvsb_tpu.robust.translation", None),
    ("GNC-TLS rotation", "psulvsb_tpu.rotation.gnc", None),
    ("Fast Global Registration rotation", "psulvsb_tpu.rotation.fgr", None),
    ("DRS certification", "psulvsb_tpu.certify.drs", None),
    ("Graph & max-clique", "psulvsb_tpu.clique.graph", None),
    ("k-core / greedy clique", "psulvsb_tpu.clique.kcore", None),
    ("PMC-equivalent native solver", "psulvsb_tpu.clique.pmc", None),
    ("GROR initializer", "psulvsb_tpu.gror.gror", None),
    ("FPFH features", "psulvsb_tpu.frontend.fpfh", None),
    ("Feature matcher", "psulvsb_tpu.frontend.matcher", None),
    ("Normals", "psulvsb_tpu.frontend.normals", None),
    ("kNN", "psulvsb_tpu.frontend.knn", None),
    ("Voxel downsampling", "psulvsb_tpu.frontend.voxel", None),
    ("ISS keypoints", "psulvsb_tpu.frontend.iss", None),
    ("ICP refinement", "psulvsb_tpu.frontend.icp", None),
    ("Normal-angle histogram prefilter",
     "psulvsb_tpu.frontend.histogram_filter", None),
    ("PLY I/O", "psulvsb_tpu.io.ply", None),
    ("Core geometry / SE(3)", "psulvsb_tpu.core.se3", None),
    ("Core linalg", "psulvsb_tpu.core.linalg", None),
    ("Metrics", "psulvsb_tpu.core.metrics", None),
    ("Pair-parallelism (mesh/shard_map)", "psulvsb_tpu.parallel.pairs", None),
    ("Pallas kernel: whole-GNC (Triton)", "psulvsb_tpu.ops.pallas_gnc", None),
    ("Pair-grid reductions", "psulvsb_tpu.ops.pair_grid", None),
    ("Kernel and reduction checks", "psulvsb_tpu.eval.kernel_checks", None),
    ("Batched dataset harness", "psulvsb_tpu.eval.batch_harness", None),
    ("Serial dataset harness", "psulvsb_tpu.eval.realdata", None),
    ("Dataset generator", "psulvsb_tpu.eval.make_dataset", None),
    ("Correspondence generation", "psulvsb_tpu.eval.corr_gen", None),
    ("Raw-cloud pipeline", "psulvsb_tpu.eval.pipeline", None),
    ("Real-scan registration", "psulvsb_tpu.eval.realscan", None),
    ("Synthetic fixtures", "psulvsb_tpu.eval.synthetic", None),
    ("Protocol driver", "psulvsb_tpu.eval.protocol", None),
    ("Reporting", "psulvsb_tpu.eval.reporting", None),
    ("Padding utilities", "psulvsb_tpu.utils.padding", None),
    ("Timing utilities", "psulvsb_tpu.utils.timing", None),
    ("Precision helpers", "psulvsb_tpu.utils.precision", None),
    ("Compile cache", "psulvsb_tpu.utils.compile_cache", None),
    ("CLI (MATLAB bridge)", "psulvsb_tpu.cli", None),
]


def _first_para(doc: str | None) -> str:
    if not doc:
        return ""
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def _is_function_like(obj) -> bool:
    """True for plain functions AND transform-wrapped callables (jax.jit
    returns a PjitFunction, which fails inspect.isfunction — the primary
    entry points of most compute modules are jit-wrapped at definition)."""
    return inspect.isfunction(obj) or (
        callable(obj)
        and not inspect.isclass(obj)
        and inspect.isfunction(getattr(obj, "__wrapped__", None))
    )


def _defining_module(obj) -> str | None:
    target = getattr(obj, "__wrapped__", obj)
    return getattr(target, "__module__", None)


def _public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = []
    for n, obj in vars(mod).items():
        if n.startswith("_"):
            continue
        if not (_is_function_like(obj) or inspect.isclass(obj)):
            continue
        if _defining_module(obj) != mod.__name__:
            continue
        names.append(n)
    return names


def _sig(obj) -> str:
    target = getattr(obj, "__wrapped__", obj)
    try:
        return str(inspect.signature(target))
    except (ValueError, TypeError):
        return "(...)"


def _doc_of(obj) -> str:
    return _first_para(
        obj.__doc__ or getattr(getattr(obj, "__wrapped__", None), "__doc__", None)
    )


def render() -> str:
    lines = [
        "# psulvsb_tpu API reference",
        "",
        "Generated by `tools/gen_api_docs.py` — do not edit by hand.",
        "",
        "Install nothing: the package runs from the repo root "
        "(`PYTHONPATH=/root/repo`). The compute path is JAX/XLA/Pallas; "
        "entry points below are grouped by subsystem.",
        "",
    ]
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        lines.append(f"## {title} — `{modname}`")
        lines.append("")
        para = _first_para(mod.__doc__)
        if para:
            lines.append(para)
            lines.append("")
        for name in names if names is not None else _public_names(mod):
            obj = getattr(mod, name, None)
            if obj is None:
                continue
            if inspect.isclass(obj):
                lines.append(f"### class `{name}`")
                lines.append("")
                p = _first_para(obj.__doc__)
                if p and not p.startswith(name + "("):  # skip namedtuple auto-doc
                    lines.append(p)
                    lines.append("")
                # NamedTuple/dataclass fields.
                fields = getattr(obj, "_fields", None)
                if fields:
                    lines.append("Fields: " + ", ".join(f"`{f}`" for f in fields))
                    lines.append("")
                for mname, meth in inspect.getmembers(obj, inspect.isfunction):
                    if mname.startswith("_") or meth.__qualname__.split(".")[0] != name:
                        continue
                    lines.append(f"- `{name}.{mname}{_sig(meth)}`")
                    mp = _first_para(meth.__doc__)
                    if mp:
                        lines.append(f"  — {mp}")
                lines.append("")
            elif _is_function_like(obj):
                lines.append(f"### `{name}{_sig(obj)}`")
                lines.append("")
                p = _doc_of(obj)
                if p:
                    lines.append(p)
                    lines.append("")
            else:
                # Constants etc. — name only; repr may embed addresses,
                # which would make regeneration nondeterministic.
                lines.append(f"### `{name}`")
                lines.append("")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    out = "docs/API.md"
    import os

    os.makedirs("docs", exist_ok=True)
    with open(out, "w") as f:
        f.write(render())
    print(f"wrote {out}")
