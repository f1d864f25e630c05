"""User-study scoring — the ``user_study/evaluation.py`` equivalent, the
port's copy of ``fmri_tpu/eval/user_study.py``.

Scores a forced-choice survey CSV (one row per participant, one column per
question, answers like ``"Option 1"``/``"Option 2"``) against per-task answer
keys, and renders the Task-3 subjective-preference bar chart where
matplotlib imports (otherwise a line on stdout says so; ``scores.json`` is
written either way).

Reference layout (``user_study/evaluation.py``): 26 participants; Tasks 1/2/4/5
are 2-AFC blocks at fixed column ranges with hard-coded keys (``:8,23,57,74``);
Task 3 is a 3-model preference whose totals were precomputed
(WAE/GAN=141, D-VAE/GAN=87, D-VAE=30, ``:41-42``).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# Reference answer keys and column ranges (user_study/evaluation.py:8-86).
REFERENCE_TASKS: Dict[str, Tuple[Tuple[int, int], List[int]]] = {
    "task1": ((2, 17), [1, 1, 2, 1, 1, 2, 2, 2, 1, 1, 2, 1, 1, 1, 2]),
    "task2": ((17, 27), [2, 1, 1, 2, 2, 1, 2, 1, 1, 2]),
    "task4": ((57, 72), [1, 1, 2, 1, 2, 1, 1, 2, 1, 2, 2, 1, 1, 2, 1]),
    "task5": ((72, 82), [2, 1, 2, 2, 1, 2, 1, 1, 2, 1]),
}

# Task-3 subjective preference totals (user_study/evaluation.py:41-42).
TASK3_PREFERENCE = {"WAE/GAN": 141, "D-VAE/GAN": 87, "D-VAE": 30}


def load_rows(csv_path: str) -> Tuple[List[str], List[Dict[str, str]]]:
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields = list(reader.fieldnames or [])
        return fields, list(reader)


def score_task(fields: Sequence[str], rows: Sequence[Dict[str, str]],
               col_range: Tuple[int, int], answers: Sequence[int]) -> float:
    """Fraction of correct forced choices over a column block
    (``evaluation.py:10-19``): the answer matches ``'Option <k>'``."""
    lo, hi = col_range
    cols = fields[lo:hi]
    if len(cols) != len(answers):
        raise ValueError(
            f"column block {col_range} has {len(cols)} columns, "
            f"but the answer key has {len(answers)}")
    score = 0
    for key, ans in zip(cols, answers):
        want = f"Option {ans}"
        score += sum(1 for row in rows if row[key] == want)
    return score / (len(answers) * len(rows))


def score_all(csv_path: str,
              tasks: Optional[Dict[str, Tuple[Tuple[int, int], List[int]]]] = None
              ) -> Dict[str, float]:
    tasks = tasks or REFERENCE_TASKS
    fields, rows = load_rows(csv_path)
    return {name: score_task(fields, rows, rng, key)
            for name, (rng, key) in tasks.items()}


def save_preference_chart(path: str,
                          preference: Optional[Dict[str, int]] = None) -> None:
    """Task-3 bar chart (``evaluation.py:41-52``), where matplotlib imports;
    otherwise a line on stdout says so."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no {path} (scores.json has the scores)")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    preference = preference or TASK3_PREFERENCE
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig = plt.figure()
    labels, values = list(preference), list(preference.values())
    bars = plt.bar(labels, values, width=0.5)
    for bar, v in zip(bars, values):
        plt.text(bar.get_x() + 0.15, v + 1, f"{v}")
    plt.ylabel("Scores")
    plt.title("Subjective assessment")
    fig.savefig(path)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_csv", help="survey results CSV (one row/participant)")
    p.add_argument("--output", "-o", default=None, help="dir for chart + JSON")
    args = p.parse_args(argv)
    scores = score_all(args.results_csv)
    print(json.dumps(scores, indent=2))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "scores.json"), "w") as f:
            json.dump(scores, f, indent=2)
        save_preference_chart(os.path.join(args.output, "task3_preference.png"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
