#!/usr/bin/env python
"""Generate docs/API.md — a one-line-per-symbol index of the public
surface (the rustdoc analog for the reference's crate docs).

Walks idsp_tpu's modules, lists public functions/classes with their
docstring summary line.  Regenerate with: python scripts/gen_api_docs.py
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    "idsp_tpu.fxp",
    "idsp_tpu.luts",
    "idsp_tpu.testing",
    "idsp_tpu.profiling",
    "idsp_tpu.checkpoint",
    "idsp_tpu.golden",
    "idsp_tpu.compat",
    "idsp_tpu.fmt",
    "idsp_tpu.process",
    "idsp_tpu.stream",
    "idsp_tpu.runtime",
    "idsp_tpu.dispatch",
    "idsp_tpu.device",
    "idsp_tpu.ops.trig",
    "idsp_tpu.ops.fastlo",
    "idsp_tpu.ops.accu",
    "idsp_tpu.ops.complex",
    "idsp_tpu.ops.cordic",
    "idsp_tpu.ops.dither",
    "idsp_tpu.ops.dsm",
    "idsp_tpu.ops.sweptsine",
    "idsp_tpu.ops.unwrap",
    "idsp_tpu.filters.biquad",
    "idsp_tpu.filters.seq_bank",
    "idsp_tpu.filters.biquad_pallas",
    "idsp_tpu.filters.svf",
    "idsp_tpu.filters.normal",
    "idsp_tpu.filters.wdf",
    "idsp_tpu.filters.wdf_pallas",
    "idsp_tpu.filters.svf_pallas",
    "idsp_tpu.filters.normal_pallas",
    "idsp_tpu.filters.rpll_pallas",
    "idsp_tpu.filters.hbf",
    "idsp_tpu.filters.cic",
    "idsp_tpu.filters.lowpass",
    "idsp_tpu.filters.lowpass_pallas",
    "idsp_tpu.filters.lockin",
    "idsp_tpu.filters.pll",
    "idsp_tpu.filters.pll_pallas",
    "idsp_tpu.filters.rpll",
    "idsp_tpu.design.coefficients",
    "idsp_tpu.design.pid",
    "idsp_tpu.design.response",
    "idsp_tpu.design.config",
    "idsp_tpu.design.errors",
    "idsp_tpu.parallel.mesh",
    "idsp_tpu.parallel.stream",
    "idsp_tpu.parallel.pipeline",
    "idsp_tpu.parallel.distributed",
    "idsp_tpu.pipelines.fm_disc",
    "idsp_tpu.pipelines.ddc_lockin",
    "idsp_tpu.pipelines.ddc_chain",
    "idsp_tpu.pipelines.ddc_bank",
    "idsp_tpu.pipelines.channelizer",
    "idsp_tpu.pipelines.rate_conversion",
]


def summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    line = doc.split("\n", 1)[0].strip()
    return line


def main():
    out = [
        "# API index — idsp_tpu",
        "",
        "Generated by `python scripts/gen_api_docs.py`; one line per",
        "public symbol (full docs in the docstrings).",
        "",
    ]
    for name in MODULES:
        mod = importlib.import_module(name)
        out.append(f"## `{name}`")
        msum = summary(mod)
        if msum:
            out.append(f"\n{msum}\n")
        rows = []
        for attr in sorted(dir(mod)):
            if attr.startswith("_"):
                continue
            obj = getattr(mod, attr)
            if inspect.ismodule(obj):
                continue
            if getattr(obj, "__module__", None) != name:
                continue
            if inspect.isfunction(obj) or inspect.isclass(obj):
                kind = "class" if inspect.isclass(obj) else "fn"
                rows.append(f"| `{attr}` | {kind} | {summary(obj)} |")
        if rows:
            out.append("| symbol | kind | summary |")
            out.append("|---|---|---|")
            out.extend(rows)
        out.append("")
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "API.md",
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
