"""Reduced-scale end-to-end accuracy study (SURVEY §0 workloads).

A copy of vit_search_tpu/tools/accuracy_study.py that drives the port's
CLIs: the same flags, stages, artifacts and summary keys, plus
``--device``, which goes to every ``cli.train`` and ``cli.evo_search``
command (the card by default, the CPU only when ``--device cpu`` asks for
it; with neither a card nor that request the first CLI fails, and so does
the study).

Runs the real pipeline — supernet training -> evolutionary search ->
winner retrain -> higher-resolution finetune -> eval-only — through the
actual CLIs on the procedural ImageFolder dataset (make_synthfolder), with
a random same-MAC candidate retrained under the identical recipe as the
control.  Produces ``RESULTS.md``-ready JSON: per-epoch curves for every
stage plus the searched-vs-random comparison.

This validates end-to-end learning (accuracy goes up under the full
augmentation/mixup/LR recipe) and the NAS contract (the searched candidate
outperforms a random candidate at the same MAC budget) without ImageNet on
disk (zero-egress environment).  The finetune stage exercises pos-embed
interpolation at ``56*(patch_len+1)`` px (reference workload #4,
finetune/*.sh), the eval stage the ``--eval`` path (workload #5).

Usage:
  python -m vit_search_torch.tools.accuracy_study --root /tmp/vst_study \
      [--classes 100] [--supernet-epochs 12] [--retrain-epochs 15] \
      [--stages supernet,search,retrain,finetune,eval] [--device cpu] ...

``--stages`` reruns individual stages against an existing root (later
stages read the earlier stages' on-disk artifacts).  Render the summary
with ``python -m vit_search_torch.tools.render_results``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def sh(cmd, log_path=None):
    print(f"+ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    with open(log_path, "ab") if log_path else open(os.devnull, "wb") as sink:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        for line in proc.stdout:
            sink.write(line)
            sink.flush()
            sys.stdout.buffer.write(line)
            sys.stdout.flush()
        proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"command failed ({proc.returncode}): {cmd}")
    print(f"  [{time.time() - t0:.0f}s]", flush=True)


def read_curve(output_dir):
    path = os.path.join(output_dir, "log.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="/tmp/vst_study")
    p.add_argument("--data", default=None, help="dataset dir (default root/data)")
    p.add_argument("--classes", type=int, default=100)
    p.add_argument("--train-per-class", type=int, default=200)
    p.add_argument("--val-per-class", type=int, default=50)
    p.add_argument("--holdout-per-class", type=int, default=25)
    p.add_argument("--img-size", type=int, default=176)
    p.add_argument("--input-size", type=int, default=224,
                   help="train/eval resolution; must be a multiple of 56 "
                        "(patch14 grid x patch-mixup grid). 112 runs the "
                        "whole study ~6x faster at reduced scale.")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--supernet-epochs", type=int, default=12)
    p.add_argument("--mask-warmup-epochs", type=int, default=3)
    p.add_argument("--retrain-epochs", type=int, default=15)
    p.add_argument("--search-iters", type=int, default=5)
    p.add_argument("--popu", type=int, default=100)
    p.add_argument("--parent-size", type=int, default=None,
                   help="evolver parents (default popu//5; published "
                        "budget uses 75 with popu 500)")
    p.add_argument("--mutate-size", type=int, default=None,
                   help="mutations (and crossovers) per iter "
                        "(default popu//5; published budget 75)")
    p.add_argument("--retrain-seeds", default="0",
                   help="comma list of seeds for winner/control retrains; "
                        ">1 seed turns the comparison into a per-seed table")
    p.add_argument("--rankcorr-k", type=int, default=8,
                   help="candidates retrained by the rankcorr stage "
                        "(picked across the search-history score range)")
    p.add_argument("--constraint", type=float, default=1.7944e9,
                   help="MAC budget (published tiny: 1.7944G)")
    p.add_argument("--example-per-arch", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--skip-generate", action="store_true",
                   help="legacy alias: drops the 'data' stage")
    p.add_argument("--finetune-epochs", type=int, default=3)
    p.add_argument("--controls", default="random",
                   help="comma list of retrain controls: 'random' (same-MAC "
                        "random draw) and/or 'worst' (lowest-scoring search-"
                        "history member)")
    p.add_argument("--stages",
                   default="data,supernet,search,retrain,finetune,eval",
                   help="comma list (also: rankcorr); later stages read "
                        "earlier stages' artifacts from --root")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card) or 'cpu', passed to every "
                        "cli.train and cli.evo_search run; no fallback")
    args = p.parse_args()
    stages = set(args.stages.split(","))
    if args.skip_generate:
        stages.discard("data")

    root = args.root
    data = args.data or os.path.join(root, "data")
    os.makedirs(root, exist_ok=True)
    log = os.path.join(root, "study.log")

    supernet_def = open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "scripts", "vit-sr-nas", "super_net", "tiny.sh")
    ).read().split("--network-def")[1].split("'")[1]
    # patch the head class count to the study's
    supernet_def = supernet_def.replace("(2, 1024, 1000)",
                                        f"(2, 1024, {args.classes})")

    # 1) dataset + pinned holdout split
    if "data" in stages:
        sh([sys.executable, "-m", "vit_search_torch.tools.make_synthfolder",
            data, "--classes", str(args.classes),
            "--train", str(args.train_per_class),
            "--val", str(args.val_per_class),
            "--size", str(args.img_size)], log)
        sh([sys.executable, "-m", "vit_search_torch.data.subset", data,
            "--per-class", str(args.holdout_per_class)], log)

    assert args.input_size % 56 == 0, "patch14 grid x patch-mixup grid"
    patch_len = args.input_size // 56

    def common_flags(size, plen):
        return ["--data-path", data, "--data-set", "IMNET",
                "--input-size", str(size),
                "--mixup-patch-len", str(plen),
                "--num_workers", str(args.num_workers),
                "--batch-size", str(args.batch_size), "--val-bs", "200",
                "--no-repeated-aug", "--seed", "0"]

    common = common_flags(args.input_size, patch_len)

    # 2) supernet training on sub-train (published tiny recipe, short)
    supernet_out = os.path.join(root, "supernet")
    if "supernet" in stages:
        sh([sys.executable, "-m", "vit_search_torch.cli.train",
            "--model", "flexible_vit_sr_patch14_224_patch_output_supernet",
            "--network-def", supernet_def, "--search-space", "sr_tiny_mh",
            "--example-per-arch", str(args.example_per_arch),
            "--num-warmup-epochs", str(args.mask_warmup_epochs),
            "--use-holdout", "--use-patch-mixup", "--drop-path", "0.2",
            "--no-model-ema", "--epochs", str(args.supernet_epochs),
            "--warmup-epochs", "1", "--output_dir", supernet_out, *common,
            "--device", args.device], log)

    # 3) evolutionary search on the holdout sub-val
    # MACs scale with token count; keep the published 224px budget meaningful
    # at reduced resolution by scaling it with the grid area.
    constraint = args.constraint * (args.input_size / 224.0) ** 2

    search_out = os.path.join(root, "search")
    if "search" in stages:
        sh([sys.executable, "-m", "vit_search_torch.cli.evo_search",
            "--data-path", data, "--val-bs", "200",
            "--num_workers", str(args.num_workers),
            "--input-size", str(args.input_size),
            "--model", "flexible_vit_sr_patch14_224_patch_output",
            "--model-path", os.path.join(supernet_out, "checkpoints",
                                         "checkpoint"),
            "--network-def", supernet_def, "--search-space", "sr_tiny_mh",
            "--constraint-value", str(constraint),
            "--search-iter", str(args.search_iters),
            "--init-popu-size", str(args.popu),
            "--parent-size", str(args.parent_size or max(4, args.popu // 5)),
            "--mutate-size", str(args.mutate_size or max(2, args.popu // 5)),
            "--output_dir", search_out, "--device", args.device], log)

    from ..arch import ComputationEstimator, get_space, parse_network_def

    est = ComputationEstimator(distill=False,
                               input_resolution=args.input_size,
                               patch_size=14)
    summary = {}
    supernet_curve = read_curve(supernet_out)
    if supernet_curve:  # don't clobber a good curve after log cleanup
        summary["supernet_curve"] = supernet_curve

    # Search-dependent stages need the search artifacts; an early-stage-only
    # run (e.g. --stages supernet) still writes its partial summary.
    history_path = os.path.join(search_out, "history.csv")
    winner_def = None
    if os.path.exists(history_path):
        with open(history_path) as f:
            history_lines = f.readlines()[1:]  # rank order, best first
        winner_def = history_lines[0].split('"')[1]
        summary.update({
            "search_best_per_iter": open(
                os.path.join(search_out, "summary.txt")).read().splitlines(),
            "winner_def": winner_def,
            "winner_mac": int(est(parse_network_def(winner_def))),
        })
    needs_search = stages & {"search", "retrain", "rankcorr", "finetune",
                             "eval"}
    if winner_def is None and needs_search:
        raise FileNotFoundError(
            f"{history_path} missing but stages {sorted(needs_search)} need "
            f"it; run the search stage first")

    seeds = [int(s) for s in str(args.retrain_seeds).split(",")]

    def retrain(tag, net, seed, epochs=None):
        """One searched-net-recipe retrain; returns its curve.

        Idempotent: a completed run (log.txt has all epochs) is reused,
        so interrupted studies resume and rankcorr can share the
        winner/worst retrains."""
        import shutil

        epochs = epochs or args.retrain_epochs
        out = os.path.join(root, f"retrain_{tag}" if seed == seeds[0]
                           else f"retrain_{tag}_s{seed}")
        existing_curve = read_curve(out)
        if len(existing_curve) >= epochs:
            print(f"retrain {tag} s{seed}: reusing completed run", flush=True)
            return existing_curve
        if os.path.isdir(out):
            shutil.rmtree(out)  # partial run: restart clean
        # common carries --seed 0; substitute this job's seed
        seeded = list(common)
        seeded[seeded.index("--seed") + 1] = str(seed)
        sh([sys.executable, "-m", "vit_search_torch.cli.train",
            "--model", "flexible_vit_sr_patch14_224_patch_output",
            "--network-def", net, "--use-patch-mixup",
            "--drop-path", "0.1", "--no-model-ema",
            "--epochs", str(epochs),
            "--warmup-epochs", "2", "--output_dir", out, *seeded,
            "--device", args.device], log)
        return read_curve(out)

    if "retrain" in stages:
        # 4) the controls: a random candidate at the same MAC budget, and
        # (optionally) the WORST-scoring same-budget member of the search
        # history — the sharper contrast when the space is dense around
        # the constraint and random draws land near the frontier.
        from ..search import gen_random_network_def

        import numpy as np

        controls = [c for c in args.controls.split(",") if c] \
            if args.controls else []
        jobs = [("winner", winner_def)]
        if "random" in controls:
            rng = np.random.default_rng(12345)
            random_def = repr(gen_random_network_def(
                parse_network_def(supernet_def), get_space("sr_tiny_mh"),
                constraint, est, rng=rng))
            jobs.append(("random", random_def))
        if "worst" in controls:
            worst_def = history_lines[-1].split('"')[1]
            jobs.append(("worst", worst_def))
        for tag, net in jobs[1:]:
            print(f"winner MAC={est(parse_network_def(winner_def))}, "
                  f"{tag} MAC={est(parse_network_def(net))}", flush=True)

        # 5) retrain all with the identical searched-net recipe, once per
        # seed (seed moves both the init and the data order)
        for tag, net in jobs:
            finals = {}
            # the seed study targets winner-vs-random; 'worst' is a
            # secondary contrast, one seed keeps the budget sane
            job_seeds = seeds[:1] if tag == "worst" else seeds
            for seed in job_seeds:
                curve = retrain(tag, net, seed)
                finals[seed] = curve[-1]["test_acc1"]
                if seed == seeds[0]:
                    summary[f"{tag}_curve"] = curve
                    summary[f"{tag}_final_acc1"] = finals[seed]
            if tag != "winner":
                summary[f"{tag}_def"] = net
                summary[f"{tag}_mac"] = int(est(parse_network_def(net)))
            if len(job_seeds) > 1:
                summary[f"{tag}_final_acc1_by_seed"] = finals

    if "rankcorr" in stages:
        # 6) fitness-vs-retrained-accuracy rank correlation: retrain K
        # candidates spread across the search history's score range and
        # compute Kendall tau between supernet holdout fitness and final
        # retrained accuracy.
        rows = []
        for line in history_lines:
            rank = int(line.split(",")[0])
            score = float(line.split(",")[1])
            rows.append((rank, score, line.split('"')[1]))
        k = min(args.rankcorr_k, len(rows))
        picks = [rows[round(i * (len(rows) - 1) / (k - 1))]
                 for i in range(k)] if k > 1 else rows[:1]
        # dedupe (rounding can collide on short histories)
        seen, chosen = set(), []
        for r in picks:
            if r[0] not in seen:
                seen.add(r[0])
                chosen.append(r)
        entries = []
        worst_def = history_lines[-1].split('"')[1]
        for rank, score, net in chosen:
            # ranks that coincide with the winner/worst control retrains
            # reuse those runs (same def, same seed, same recipe)
            tag = ("winner" if net == winner_def
                   else "worst" if net == worst_def else f"rc{rank}")
            curve = retrain(tag, net, seeds[0])
            entries.append({"history_rank": rank, "fitness": score,
                            "mac": int(est(parse_network_def(net))),
                            "retrained_acc1": curve[-1]["test_acc1"],
                            "network_def": net})
            print(f"rankcorr: rank={rank} fitness={score:.3f} "
                  f"-> acc1={entries[-1]['retrained_acc1']:.2f}", flush=True)
        n = len(entries)
        concordant = discordant = 0
        for i in range(n):
            for j in range(i + 1, n):
                df = entries[i]["fitness"] - entries[j]["fitness"]
                da = entries[i]["retrained_acc1"] - entries[j]["retrained_acc1"]
                prod = df * da
                if prod > 0:
                    concordant += 1
                elif prod < 0:
                    discordant += 1
        pairs = n * (n - 1) // 2
        summary["rankcorr"] = {
            "entries": entries,
            "kendall_tau": ((concordant - discordant) / pairs
                            if pairs else None),
            "concordant": concordant, "discordant": discordant,
        }

    # 6) higher-resolution finetune of the retrained winner: pos-embed
    # interpolation at the next 56-multiple (reference workload #4;
    # finetune scripts use lr 5e-6/wd 1e-8 over 30 epochs — scaled here)
    ft_len = patch_len + 1
    ft_size = 56 * ft_len
    ft_out = os.path.join(root, "finetune")
    ft_common = common_flags(ft_size, ft_len)
    if "finetune" in stages:
        sh([sys.executable, "-m", "vit_search_torch.cli.train",
            "--model", "flexible_vit_sr_patch14_224_patch_output",
            "--network-def", winner_def, "--use-patch-mixup",
            "--finetune", os.path.join(root, "retrain_winner", "checkpoints",
                                       "checkpoint"),
            "--lr", "2e-5", "--weight-decay", "1e-8", "--drop-path", "0.1",
            "--no-model-ema", "--epochs", str(args.finetune_epochs),
            "--warmup-epochs", "0", "--output_dir", ft_out, *ft_common,
            "--device", args.device], log)
        summary["finetune_size"] = ft_size
        summary["finetune_curve"] = read_curve(ft_out)

    # 7) standalone evaluation of the finetuned checkpoint (workload #5)
    if "eval" in stages:
        eval_log = os.path.join(root, "eval.log")
        open(eval_log, "w").close()
        sh([sys.executable, "-m", "vit_search_torch.cli.train",
            "--eval", "--resume", os.path.join(ft_out, "checkpoints",
                                               "checkpoint"),
            "--model", "flexible_vit_sr_patch14_224_patch_output",
            "--network-def", winner_def, "--no-model-ema",
            "--output_dir", os.path.join(root, "eval_out"), *ft_common,
            "--device", args.device], eval_log)
        with open(eval_log) as f:
            eval_lines = [ln for ln in f if "eval:" in ln]
        summary["eval_only"] = eval_lines[-1].split("eval:", 1)[1].strip() \
            if eval_lines else "(not captured)"

    existing = {}
    summary_path = os.path.join(root, "study_summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            existing = json.load(f)
    if "retrain" in stages:
        # a rerun with different --controls must not leave the previous
        # run's control keys behind (render_results would still show them)
        controls_now = set(args.controls.split(",")) if args.controls else set()
        for tag in ("random", "worst"):
            if tag not in controls_now:
                for key in list(existing):
                    if key.startswith(f"{tag}_"):
                        del existing[key]
    existing.update(summary)
    summary = existing
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if not k.endswith("curve")
                      and k != "supernet_curve"}, indent=1))


if __name__ == "__main__":
    main()
