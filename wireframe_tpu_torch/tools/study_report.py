"""Paired seed-study comparison report over seed_study results.jsonl.

The port's copy of the repository's `tools/study_report.py`: for
explicit selectors (`tag:variant` on the control) the same tables, byte
for byte.  One deliberate divergence: a control given WITHOUT a variant
is paired, for each treatment, against the control's rows of THAT
treatment's variant (`--control c --tags t:ema` pairs `t:ema` with
`c:ema`), and the table's header says so.  The repository's tool
defaults the control to `final` and so pairs `t:ema` with `c:final`.

`tools/seed_study.py` records one JSON line per (tag, seed, variant)
and prints a per-tag mean ± std — but the QUALITY.md verdicts hinge on
*paired* statistics: per-seed deltas vs a control recipe, how many
seeds moved which way, and whether the mean delta clears one seed-SD.
Those tables were assembled by hand in rounds 3–4; this tool emits
them directly so every future study (and the reproduce instructions in
QUALITY.md) uses one audited code path.

A selector is `tag` or `tag:variant` (a treatment's variant defaults to
`final`, a control's to each treatment's; `ema` selects the
EMA-checkpoint eval rows that `--eval-ema` records).
The control and each treatment are paired BY SEED — seeds missing from
either side are dropped from that pairing and reported, so a partially
complete study never silently averages unpaired seeds.

Usage:
  python -m wireframe_tpu_torch.tools.study_report \
      --results build/seed_study/results.jsonl \
      --control recipe --tags pretrain_ft,pretrain_ft_lr03:ema

Reference anchor: the quality numbers being compared against are the
reference's published test metrics (its README.md:110-115); the counting
rules live in metrics/ap_calculator.py.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

# Higher-is-better flags drive the up/down arrow direction per metric.
METRICS = (
    ("edge_f1", "E-F1", True),
    ("wed", "WED", False),
    ("corner_f1", "C-F1", True),
    ("corner_p", "C-P", True),
    ("aco", "ACO", False),
)


def load_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def parse_selector(sel: str) -> tuple[str, str]:
    """A treatment selector: the variant defaults to `final`."""
    tag, _, variant = sel.partition(":")
    return tag, (variant or "final")


def parse_control(sel: str) -> tuple[str, str | None]:
    """A control selector: the variant is None when not given, and the
    control then takes each treatment's variant."""
    tag, _, variant = sel.partition(":")
    return tag, (variant or None)


def control_selectors(control, treatments) -> list[tuple[str, str]]:
    """The control's (tag, variant) rows the treatments pair against."""
    ctag, cvar = control
    if cvar is not None:
        return [(ctag, cvar)]
    return list(dict.fromkeys((ctag, v) for _, v in treatments))


def by_seed(rows: list[dict], tag: str, variant: str) -> dict[int, dict]:
    out = {}
    for r in rows:
        if r.get("tag") == tag and r.get("variant", "final") == variant:
            # Last record wins: seed_study appends, so a re-run of a
            # seed supersedes the earlier line.
            out[int(r["seed"])] = r
    return out


def fmt_mean(vals: list[float]) -> str:
    if not vals:
        return "—"
    if len(vals) == 1:
        return f"{vals[0]:.3f}"
    return f"{statistics.mean(vals):.3f} ± {statistics.stdev(vals):.3f}"


def summary_table(rows, selectors) -> list[str]:
    lines = ["| study (variant) | n | " +
             " | ".join(label for _, label, _ in METRICS) + " |",
             "|---|---|" + "---|" * len(METRICS)]
    for tag, variant in selectors:
        recs = by_seed(rows, tag, variant)
        cells = []
        for key, _, _ in METRICS:
            cells.append(fmt_mean([r[key] for r in recs.values() if key in r]))
        lines.append(f"| {tag} ({variant}) | {len(recs)} | " +
                     " | ".join(cells) + " |")
    return lines


def paired_table(rows, control, treatments) -> list[str]:
    """Per-seed deltas of each treatment against the control.  A control
    without a variant (`parse_control`) pairs each treatment against its
    own variant's control rows, one table per variant."""
    ctag, cvar = control
    if cvar is not None:
        groups = [(cvar, treatments, "")]
    else:
        groups = [(v, [t for t in treatments if t[1] == v],
                   "; the control's variant follows the treatment's")
                  for _, v in control_selectors(control, treatments)]
    lines = []
    for variant, group, note in groups:
        if lines:
            lines.append("")
        lines += _paired_group(rows, (ctag, variant), group, note)
    return lines


def _paired_group(rows, control, treatments, header_note) -> list[str]:
    ctag, cvar = control
    crecs = by_seed(rows, ctag, cvar)
    lines = [f"Paired vs control `{ctag}:{cvar}` (n={len(crecs)} seeds"
             f"{header_note}):", ""]
    lines += ["| treatment | metric | mean Δ | seeds better | per-seed Δ |",
              "|---|---|---|---|---|"]
    for tag, variant in treatments:
        trecs = by_seed(rows, tag, variant)
        seeds = sorted(set(crecs) & set(trecs))
        dropped = sorted((set(crecs) | set(trecs)) - set(seeds))
        for key, label, higher_better in METRICS:
            deltas = [trecs[s][key] - crecs[s][key] for s in seeds
                      if key in trecs[s] and key in crecs[s]]
            if not deltas:
                continue
            better = sum(1 for d in deltas
                         if (d > 0) == higher_better and d != 0)
            note = f" (seeds {dropped} unpaired)" if dropped else ""
            lines.append(
                f"| {tag} ({variant}) | {label} | "
                f"{statistics.mean(deltas):+.3f} | {better}/{len(deltas)} | "
                + "/".join(f"{d:+.3f}" for d in deltas) + note + " |")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--results", required=True,
                   help="seed_study results.jsonl path")
    p.add_argument("--control", required=True,
                   help="control selector, `tag:variant`, or `tag` to pair "
                        "each treatment with the control's rows of its "
                        "own variant")
    p.add_argument("--tags", required=True,
                   help="comma-separated treatment selectors")
    args = p.parse_args(argv)

    rows = load_rows(args.results)
    control = parse_control(args.control)
    treatments = [parse_selector(s) for s in args.tags.split(",") if s]

    print("\n".join(summary_table(
        rows, control_selectors(control, treatments) + treatments)))
    print()
    print("\n".join(paired_table(rows, control, treatments)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
