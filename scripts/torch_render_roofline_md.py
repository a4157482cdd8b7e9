"""Render the port's dry-run rows as a markdown table (port of
``scripts/render_roofline_md.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes \\
        --json rows.json [--device cpu]
    python scripts/torch_render_roofline_md.py rows.json [--wall-s S] \\
        [--host NAME]

One row per (arch, shape): each mesh's peak GB a device, the 16x16 mesh's
roofline terms on the H100 (compute, memory, collective: per-chip seconds
a step), its bottleneck and collectives by kind (GB on a device and
counts), and the trace seconds of both meshes.  ``skip`` rows (the
reference's long_500k rule) are listed under the table, and a ``FAIL``
row is printed in place.
"""
import argparse
import json
from collections import OrderedDict

SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def _coll(det: dict) -> str:
    parts = []
    for kind, tag in SHORT.items():
        n = det.get(kind + "_count", 0)
        if n:
            parts.append(f"{tag} {det.get(kind, 0) / 1e9:.3g} GB ×{n}")
    return ", ".join(parts) or "none"


def render(rows: list, wall_s=None, host=None) -> str:
    pairs = OrderedDict()
    for r in rows:
        pairs.setdefault((r["arch"], r["shape"]), {})[r.get("mesh")] = r
    out = ["| arch | shape | peak GB/dev 16x16 / 2x16x16 | t_compute s | "
           "t_memory s | t_collective s | bottleneck | collectives a "
           "device (16x16) | trace s |",
           "|---|---|---|---|---|---|---|---|---|"]
    skipped = []
    for (arch, shape), by_mesh in pairs.items():
        one = next(iter(by_mesh.values()))
        if one["status"] == "skip":
            skipped.append(f"{arch} × {shape}")
            continue
        bad = [r for r in by_mesh.values() if r["status"] != "ok"]
        if bad:
            out.append(f"| {arch} | {shape} | FAIL | | | | "
                       f"{bad[0].get('error', '')[:60]} | | |")
            continue
        single = by_mesh.get("16x16", one)
        multi = by_mesh.get("2x16x16")
        peak = f"{single['peak_gb']:.2f}" + \
            (f" / {multi['peak_gb']:.2f}" if multi else "")
        trace = f"{single['trace_s']}" + \
            (f" / {multi['trace_s']}" if multi else "")
        out.append(
            f"| {arch} | {shape} | {peak} | {single['t_compute_s']:.3g} | "
            f"{single['t_memory_s']:.3g} | {single['t_collective_s']:.3g} | "
            f"{single['bottleneck']} | {_coll(single['coll_detail'])} | "
            f"{trace} |")
    if skipped:
        out.append("")
        out.append(f"`skip` (the reference's long_500k rule): "
                   f"{', '.join(skipped)}.")
    n_ok = sum(r["status"] == "ok" for r in rows)
    tail = f"{n_ok} ok rows of {len(rows)}"
    if wall_s is not None:
        tail += f", the CLI's wall {wall_s} s"
    if host:
        tail += f" on {host}"
    out.append(tail + ".")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", help="the dry run's --json file")
    ap.add_argument("--wall-s", default=None)
    ap.add_argument("--host", default=None)
    args = ap.parse_args(argv)
    with open(args.rows) as f:
        print(render(json.load(f), args.wall_s, args.host))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
