"""Regenerate artifacts/waterfalls.png from the committed waterfall
CSVs (report/plots.py; SURVEY.md C15).  Pure host work; rerun whenever
a new family waterfall artifact lands."""

import csv
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ART = os.path.join(REPO, "artifacts")

CURVES = [
    ("judged (1024,512) minsum-50", "judged_minsum50.csv"),
    ("judged layered-25", "judged_layered25.csv"),
    ("wifi_r12_z81 minsum-50", "wifi_r12_z81_minsum50.csv"),
    ("wifi_r56_z81 minsum-50", "wifi_r56_z81_minsum50.csv"),
    ("wimax_r12_z96 minsum-50", "wimax_r12_z96_minsum50.csv"),
    ("nr1_r12_z64 minsum-50 (punctured)", "nr1_r12_z64_minsum50.csv"),
    ("nr1_r56_z64 minsum-50 (punctured)", "nr1_r56_z64_minsum50.csv"),
    ("nr2_r15_z64 rate-1/5 (punctured)", "nr2_r15_z64_minsum50.csv"),
    ("nr1_r12_z32 minsum-50 (punctured)", "nr1_r12_z32_minsum50.csv"),
    ("nr2_r15_z32 rate-1/5 (punctured)", "nr2_r15_z32_minsum50.csv"),
]


class Row:
    def __init__(self, d):
        self.ebn0_db = float(d["ebn0_db"])
        self.fer = float(d["fer"])
        self.ber = float(d["ber"])


def load(path):
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    return [Row(d) for d in csv.DictReader(lines)
            if float(d["fer"]) > 0]


def main():
    from tpu_ldpc.report.plots import plot_waterfall

    runs = {}
    for label, fname in CURVES:
        path = os.path.join(ART, fname)
        if os.path.exists(path):
            rows = load(path)
            if rows:
                runs[label] = rows
    out = plot_waterfall(
        runs, os.path.join(ART, "waterfalls.png"),
        title="FER waterfalls (min-sum a=0.75)")
    print("wrote", out, f"({len(runs)} curves)")


if __name__ == "__main__":
    main()
