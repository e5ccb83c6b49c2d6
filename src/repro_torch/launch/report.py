"""Render dry-run records as roofline tables (port of the JAX package's
``launch/report.py``: the same text for the same records).

Usage: python -m repro_torch.launch.report results/dryrun_pod16x16.json
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def render(recs, title):
    lines = [f"### {title}", ""]
    lines.append(
        "| arch | shape | kind | t_compute (s) | t_memory (s) | t_coll (s) |"
        " bottleneck | roofline frac | MODEL/HLO flops | temp GiB | status |")
    lines.append("|" + "---|" * 11)
    for r in recs:
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('kind','')} |  |  |  |"
                f"  |  |  |  | FAIL: {str(r.get('error'))[:60]} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['t_compute']:.3e} | {r['t_memory']:.3e} "
            f"| {r['t_collective']:.3e} | {r['bottleneck']} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r['model_flops_ratio']:.2f} "
            f"| {fmt_bytes(r['temp_bytes'])} | OK |")
    lines.append("")
    ok = [r for r in recs if r.get("ok")]
    if ok:
        by_b = {}
        for r in ok:
            by_b.setdefault(r["bottleneck"], []).append(r)
        lines.append(f"**{len(ok)}/{len(recs)} cells compiled.** Bottlenecks: "
                     + ", ".join(f"{k}: {len(v)}" for k, v in
                                 sorted(by_b.items())))
        worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:3]
        lines.append("Worst roofline fractions: "
                     + ", ".join(f"{r['arch']}×{r['shape']}"
                                 f" ({r['roofline_fraction']:.3f})"
                                 for r in worst))
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    out = []
    for path in (sys.argv[1:] if argv is None else argv):
        with open(path) as f:
            recs = json.load(f)
        meshes = sorted({r["mesh"] for r in recs})
        for m in meshes:
            out.append(render([r for r in recs if r["mesh"] == m],
                              f"Mesh {m} ({path})"))
    print("\n".join(out))


if __name__ == "__main__":
    main()
