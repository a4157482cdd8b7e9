#!/usr/bin/env python
"""Run the repro_torch.analysis static lint over source trees (the port of
scripts/repro_lint.py).

Usage::

    python scripts/torch_lint.py                  # gate mode: src/repro_torch
    python scripts/torch_lint.py --no-allowlist src/repro_torch   # raw

Exits nonzero when any finding survives the allowlist, or when an
allowlist entry is stale (matches nothing) — the gate must track
reality in both directions.  The hot-path rules start from the port's
round loops (``rng_lint.LOOP_ROOTS``); a root that the linted files do
not hold is a ``loop-root-stale`` finding.  See DESIGN.md §15.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.analysis import (  # noqa: E402
    LOOP_ROOTS, apply_allowlist, load_allowlist, lint_paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("roots", nargs="*",
                    help="files or directories to lint (default: the "
                         "port's package, src/repro_torch)")
    ap.add_argument("--repo-root", default=None,
                    help="paths in findings are relative to this (default: "
                         "the working directory, the repository with the "
                         "default roots)")
    ap.add_argument("--allowlist", default=None,
                    help="alternate allowlist.toml (default: the package's)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report raw findings without filtering")
    args = ap.parse_args(argv)

    roots = args.roots or [os.path.join(REPO, "src", "repro_torch")]
    repo_root = args.repo_root or ("." if args.roots else REPO)
    raw = lint_paths(roots, repo_root=repo_root, loop_roots=LOOP_ROOTS)
    if args.no_allowlist:
        kept, stale, entries = raw, [], []
    else:
        entries = load_allowlist(args.allowlist) if args.allowlist \
            else load_allowlist()
        kept, stale = apply_allowlist(raw, entries)

    for f in kept:
        print(f.render())
    for e in stale:
        print(f"stale allowlist entry: {e.rule} {e.path} "
              f"[{e.symbol or '<module>'}] — matches nothing; remove it")
    n_allowed = len(raw) - len(kept)
    status = "FAIL" if (kept or stale) else "OK"
    print(f"torch-lint: {status} — {len(kept)} finding(s), "
          f"{n_allowed} allowlisted, {len(stale)} stale entr(y/ies)")
    return 1 if (kept or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
