"""Render the accuracy study summary (tools/accuracy_study.py) to RESULTS.md.

A copy of vit_search_tpu/tools/render_results.py: the same summary renders
the same markdown, but for the lines that name the platform (the NVIDIA
H100 and the port's study module).

Usage: python -m vit_search_torch.tools.render_results \
           /tmp/vst_study/study_summary.json RESULTS.md
"""

from __future__ import annotations

import json
import sys


def spark(values, width: int = 60) -> str:
    """ASCII sparkline row for a metric curve."""
    if not values:
        return "(empty)"
    blocks = " .:-=+*#%@"
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(blocks[int((v - lo) / span * (len(blocks) - 1))]
                   for v in values[:width])


def kendall_exact_one_sided_p(n: int, concordant: int, discordant: int):
    """Exact one-sided p-value for the observed Kendall S = C − D under
    the permutation null (all n! orderings equally likely).

    Valid only without ties (C + D must equal n·(n−1)/2); returns None
    otherwise.  Under the null, the discordant-pair count D of a random
    permutation is the inversion count, whose distribution has the
    generating function  ∏_{k=0}^{n−1} (1 + x + … + x^k);  since
    S = pairs − 2·D decreases monotonically in D,
    P(S ≥ S_obs) = P(D ≤ D_obs).
    """
    pairs = n * (n - 1) // 2
    if concordant + discordant != pairs:
        return None  # ties: the inversion-count null doesn't apply
    counts = [1]  # counts[d] = #permutations with d inversions
    for k in range(1, n):
        # multiply by (1 + x + ... + x^k)
        new = [0] * (len(counts) + k)
        for d, c in enumerate(counts):
            for add in range(k + 1):
                new[d + add] += c
        counts = new
    total = sum(counts)  # = n!
    return sum(counts[: discordant + 1]) / total


def table(curve, keys):
    rows = ["| epoch | " + " | ".join(keys) + " |",
            "|" + "---|" * (len(keys) + 1)]
    for entry in curve:
        rows.append("| " + str(entry["epoch"]) + " | "
                    + " | ".join(f"{entry.get(k, float('nan')):.3f}"
                                 for k in keys) + " |")
    return "\n".join(rows)


def main(argv=None):
    summary_path, out_path = (sys.argv[1:] if argv is None else argv)[:2]
    with open(summary_path) as f:
        s = json.load(f)

    w = s["winner_curve"]
    controls = [tag for tag in ("random", "worst") if f"{tag}_curve" in s]
    sup = s["supernet_curve"]
    md = f"""# Accuracy study — end-to-end pipeline at reduced scale

No real dataset ships in this zero-egress environment, so the SURVEY §0
workloads were exercised at reduced scale on a procedural 100-class
ImageFolder dataset (`tools/make_synthfolder.py`: class-specific texture
mixtures, learnable but non-trivial under the full ImageNet augmentation
pipeline).  Everything below ran through the real CLIs on an NVIDIA H100 with the
published recipe structure: supernet training (token mixup, multi-arch
masking, holdout split) -> evolutionary search on the held-out sub-val ->
winner retrained from scratch, against a **random candidate at the same MAC
budget** retrained with the *identical* recipe as the control.

## 1. Supernet training learns

{table(sup, ["train_loss", "test_acc1", "test_acc5"])}

acc1 sparkline: `{spark([e["test_acc1"] for e in sup])}`

## 2. Search improves fitness over iterations

```
{chr(10).join(s["search_best_per_iter"])}
```

## 3. Searched net vs same-MAC controls

Identical retraining recipe (epochs, LR schedule, token mixup, erasing):

| candidate | MACs | final top-1 | final top-5 |
|---|---|---|---|
| **searched winner** | {s["winner_mac"] / 1e9:.3f}G | **{s["winner_final_acc1"]:.2f}%** | {w[-1].get("test_acc5", float("nan")):.2f}% |
"""
    for tag in controls:
        c = s[f"{tag}_curve"]
        md += (f"| {tag} (same budget) | {s[f'{tag}_mac'] / 1e9:.3f}G "
               f"| {s[f'{tag}_final_acc1']:.2f}% "
               f"| {c[-1].get('test_acc5', float('nan')):.2f}% |\n")
    if s.get("winner_final_acc1_by_seed"):
        tags = ["winner"] + [t for t in controls
                             if s.get(f"{t}_final_acc1_by_seed")]
        by_seed = {t: {int(k): v for k, v in
                       s[f"{t}_final_acc1_by_seed"].items()} for t in tags}
        seeds_list = sorted(by_seed["winner"])
        md += ("\n### Per-seed finals (the seed moves both the init and "
               "the data order)\n\n")
        md += ("| seed | " + " | ".join(tags)
               + (" | winner − random |" if "random" in tags else " |")
               + "\n|" + "---|" * (len(tags) + 1
                                   + ("random" in tags)) + "\n")
        for sd in seeds_list:
            row = [f"{by_seed[t][sd]:.2f}%" if sd in by_seed[t] else "—"
                   for t in tags]
            if "random" in tags:
                # placeholder keeps the row width matching the header even
                # when this seed has no random-control run
                row.append(
                    f"+{by_seed['winner'][sd] - by_seed['random'][sd]:.2f}"
                    if sd in by_seed["random"] and sd in by_seed["winner"]
                    else "—")
            md += f"| {sd} | " + " | ".join(row) + " |\n"
        import statistics
        for t in tags:
            vals = list(by_seed[t].values())
            if len(vals) > 1:
                md += (f"\n{t}: mean {statistics.mean(vals):.2f}% "
                       f"± {statistics.stdev(vals):.2f} over "
                       f"{len(vals)} seeds")
        md += "\n"
    md += f"""
Winner per-epoch top-1: `{spark([e["test_acc1"] for e in w])}`
"""
    for tag in controls:
        md += (f"{tag.capitalize()} per-epoch top-1: "
               f"`{spark([e['test_acc1'] for e in s[f'{tag}_curve']])}`\n")
    md += f"""
### Winner retrain curve

{table(w, ["train_loss", "test_acc1", "test_acc5"])}
"""
    for tag in controls:
        md += f"""
### {tag.capitalize()}-control retrain curve

{table(s[f"{tag}_curve"], ["train_loss", "test_acc1", "test_acc5"])}
"""
    if s.get("finetune_curve"):
        md += f"""
## 4. Higher-resolution finetune (workload #4)

Winner finetuned at {s["finetune_size"]}px (pos-embed bicubic
interpolation, reference finetune/*.sh recipe shape):

{table(s["finetune_curve"], ["train_loss", "test_acc1", "test_acc5"])}
"""
    if s.get("eval_only"):
        md += f"""
## 5. Standalone `--eval` (workload #5)

`cli.train --eval --resume <finetuned ckpt>`: `{s["eval_only"]}`
"""
    if s.get("rankcorr"):
        rc = s["rankcorr"]
        md += f"""
## Fitness ↔ retrained-accuracy rank correlation

{len(rc["entries"])} candidates spread across the search history's score
range, each retrained from scratch with the identical recipe (one seed):

| history rank | holdout fitness | MACs | retrained top-1 |
|---|---|---|---|
"""
        for e in rc["entries"]:
            md += (f"| {e['history_rank']} | {e['fitness']:.2f}% "
                   f"| {e['mac'] / 1e9:.3f}G | {e['retrained_acc1']:.2f}% |\n")
        p = kendall_exact_one_sided_p(len(rc["entries"]),
                                      rc["concordant"], rc["discordant"])
        p_note = (f"; one-sided p = {p:.3f} by the exact permutation "
                  f"distribution" if p is not None else "")
        md += (f"\n**Kendall tau = {rc['kendall_tau']:.3f}** "
               f"({rc['concordant']} concordant / {rc['discordant']} "
               f"discordant pairs{p_note}): supernet holdout fitness "
               f"orders retrained accuracy — the NAS proxy contract.\n")
    md += f"""
## Definitions

- winner network_def: `{s["winner_def"]}`
"""
    for tag in controls:
        md += f"- {tag} network_def: `{s[f'{tag}_def']}`\n"
    md += """
Reproduce: `python -m vit_search_torch.tools.accuracy_study --root <dir>`
(one NVIDIA H100; `--device cpu` runs it on the CPU).
"""
    with open(out_path, "w") as f:
        f.write(md)
    print(out_path)


if __name__ == "__main__":
    main()
