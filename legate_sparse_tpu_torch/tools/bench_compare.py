# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Diff bench JSONs field by field with measured noise bands: the
perf-regression gate over ``bench_torch.py``'s results (the port of
``tools/bench_compare.py`` over ``obs/regress.py``; same flags, same
text, same exit status).

``*_ms`` (lower is better), ``*_roofline_ratio`` (higher is better)
and ``*_comm_bytes`` (deterministic interconnect counts) are compared
with a noise band derived from the recorded ``stream_samples`` spread
of both runs, and the exit status is nonzero on any out-of-band
regression, or on a gated field that vanished from the newer run.

Usage::

    # explicit pair (old, new): a run wrapper {"parsed": ...}, a raw
    # bench JSON, or a log whose last JSON line is one
    python -m legate_sparse_tpu_torch.tools.bench_compare old.json new.json

    # the whole trajectory: renders the table over BENCH_r0*.json in
    # DIR (default .) and gates newest vs previous
    python -m legate_sparse_tpu_torch.tools.bench_compare --trajectory --dir DIR

    # restrict the gate (e.g. deterministic fields only)
    python -m legate_sparse_tpu_torch.tools.bench_compare old.json new.json \
        --fields '*_comm_bytes,dist_shards,schema_version'

Knobs: ``--band-mult`` scales the stream-spread noise band (default
3.0), ``--floor`` floors it for runs without spread data (default
0.25), ``--comm-tol`` is the fixed tolerance for byte counts (default
0.01), ``--allow-missing`` downgrades vanished fields to informational.
Exit status: 0 clean, 1 regression(s) or missing gated fields, 2 usage
or unreadable input.  It reads files only: no device is touched.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..obs import regress


def _gate(old, new, args) -> int:
    fields = ([p.strip() for p in args.fields.split(",") if p.strip()]
              if args.fields else None)
    findings = regress.compare(
        old, new, band_mult=args.band_mult, floor=args.floor,
        comm_tol=args.comm_tol, fields=fields,
        allow_missing=args.allow_missing,
    )
    band = regress.noise_band(old, new, floor=args.floor)
    print(regress.render_findings(findings, band=band))
    bad = regress.regressions(findings)
    if bad:
        print(f"\nREGRESSED: {len(bad)} field(s): "
              + ", ".join(f["field"] for f in bad), file=sys.stderr)
        return 1
    print("\nclean: no out-of-band regressions")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Bench JSON regression gate / trajectory table.")
    ap.add_argument("old", nargs="?", help="older bench artifact")
    ap.add_argument("new", nargs="?", help="newer bench artifact")
    ap.add_argument("--trajectory", action="store_true",
                    help="render the BENCH_r0*.json trajectory table "
                         "and gate newest vs previous")
    ap.add_argument("--dir", default=".",
                    help="directory holding BENCH_r0*.json "
                         "(trajectory mode; default .)")
    ap.add_argument("--band-mult", type=float,
                    default=regress.DEFAULT_BAND_MULT,
                    help="noise-band multiplier on the stream-sample "
                         "spread (default %(default)s)")
    ap.add_argument("--floor", type=float, default=regress.DEFAULT_FLOOR,
                    help="relative noise-band floor (default "
                         "%(default)s)")
    ap.add_argument("--comm-tol", type=float, default=regress.COMM_TOL,
                    help="tolerance for *_comm_bytes fields (default "
                         "%(default)s)")
    ap.add_argument("--fields", default=None,
                    help="comma-separated fnmatch patterns restricting "
                         "the gated fields")
    ap.add_argument("--allow-missing", action="store_true",
                    help="vanished gated fields are informational, "
                         "not failures")
    args = ap.parse_args(argv)

    if args.trajectory:
        paths = sorted(glob.glob(os.path.join(args.dir,
                                              "BENCH_r[0-9]*.json")))
        if not paths:
            print(f"{args.dir}: no BENCH_r*.json artifacts",
                  file=sys.stderr)
            return 2
        rounds, labels = [], []
        for p in paths:
            try:
                rounds.append(regress.load_bench(p))
                labels.append(os.path.basename(p)
                              .replace("BENCH_", "").replace(".json", ""))
            except (OSError, ValueError) as e:
                print(f"skipping {p}: {e}", file=sys.stderr)
        if not rounds:
            return 2
        print(regress.render_trajectory(rounds, labels))
        if len(rounds) < 2:
            return 0
        print(f"\ngate: {labels[-2]} -> {labels[-1]}")
        return _gate(rounds[-2], rounds[-1], args)

    if not (args.old and args.new):
        ap.print_usage(sys.stderr)
        return 2
    try:
        old = regress.load_bench(args.old)
        new = regress.load_bench(args.new)
    except (OSError, ValueError) as e:
        print(f"bench_compare: {e}", file=sys.stderr)
        return 2
    return _gate(old, new, args)


if __name__ == "__main__":
    sys.exit(main())
