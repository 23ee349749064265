"""Vertical-FL (feature-partitioned) readers: NUS-WIDE and Lending Club
(``fedml_tpu.data.vertical``, copied: csv and numpy only).

- NUS-WIDE, two parties: party A the 634 low-level image features
  (``Low_Level_Features/{Train,Test}_Normalized_*.dat``, space
  separated), party B the 1k tags (``NUS_WID_Tags/{Train,Test}_Tags1k.dat``,
  tab separated); the labels from ``Groundtruth/TrainTestLabels/
  Labels_<concept>_{Train,Test}.txt``, keeping the rows with exactly one
  of the selected concepts.
- Lending Club, two parties from ``loan.csv``: party A the
  qualification and loan features, party B the debt, repayment, account
  and behaviour features, categoricals mapped with the reference's maps,
  numbers coerced (a blank is 0), every column standardized; the target
  the bad-loan indicator.

Both return ``{"train": (x, y), "test": (x, y), "splits": [(lo, hi),
...]}``, the parties as contiguous column ranges of one matrix, which
:class:`fedml_tpu_torch.algorithms.split.VFLSim` takes as they are.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _standardize(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True)
    return (x - mu) / np.maximum(sd, 1e-8)


# ---------------------------------------------------------------------------
# NUS-WIDE
# ---------------------------------------------------------------------------


def load_nus_wide_two_party(
    data_dir: str,
    selected_labels: list[str] | None = None,
    n_samples: int = -1,
    binary_positive: str | None = None,
):
    """Two-party NUS-WIDE (reference ``get_labeled_data_with_2_party``):
    returns ``(x, y, splits)`` per split in a dict
    ``{"train": (x, y), "test": (x, y), "splits": [(lo, hi), ...]}``.

    ``x`` = [XA | XB] column-concatenated; ``y`` = argmax over the selected
    concepts (or, with ``binary_positive``, 1 for that concept). Rows keep
    only samples with EXACTLY one active concept, like the reference."""
    if selected_labels is None:
        selected_labels = ["buildings", "grass", "animal", "water", "person"]

    def read_split(dtype: str):
        label_cols = []
        for lab in selected_labels:
            p = os.path.join(
                data_dir, "Groundtruth", "TrainTestLabels",
                f"Labels_{lab}_{dtype}.txt",
            )
            label_cols.append(np.loadtxt(p, dtype=np.int64))
        labels = np.stack(label_cols, axis=1)  # [N, k]
        keep = labels.sum(axis=1) == 1 if labels.shape[1] > 1 else slice(None)

        feat_dir = os.path.join(data_dir, "Low_Level_Features")
        fa = []
        for fn in sorted(os.listdir(feat_dir)):
            if fn.startswith(f"{dtype}_Normalized"):
                fa.append(np.loadtxt(os.path.join(feat_dir, fn),
                                     dtype=np.float32))
        xa = np.concatenate([np.atleast_2d(a) for a in fa], axis=1)

        tag_p = os.path.join(
            data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat"
        )
        xb = np.loadtxt(tag_p, dtype=np.float32, delimiter="\t")
        xb = np.atleast_2d(xb)

        xa, xb, labels = xa[keep], xb[keep], labels[keep]
        if binary_positive is not None:
            y = labels[:, selected_labels.index(binary_positive)]
        else:
            y = labels.argmax(axis=1)
        if n_samples != -1:
            xa, xb, y = xa[:n_samples], xb[:n_samples], y[:n_samples]
        da = xa.shape[1]
        return (
            np.concatenate([xa, xb], axis=1).astype(np.float32),
            y.astype(np.int64),
            [(0, da), (da, da + xb.shape[1])],
        )

    x_tr, y_tr, splits = read_split("Train")
    x_te, y_te, _ = read_split("Test")
    return {
        "train": (x_tr, y_tr),
        "test": (x_te, y_te),
        "splits": splits,
    }


# ---------------------------------------------------------------------------
# Lending Club
# ---------------------------------------------------------------------------

_GRADE = {"A": 6, "B": 5, "C": 4, "D": 3, "E": 2, "F": 1, "G": 0}
_EMP_LENGTH = {
    "": 0, "< 1 year": 1, "1 year": 2, "2 years": 2, "3 years": 2,
    "4 years": 3, "5 years": 3, "6 years": 3, "7 years": 4, "8 years": 4,
    "9 years": 4, "10+ years": 5,
}
_HOME = {"RENT": 0, "MORTGAGE": 1, "OWN": 2, "ANY": 3, "NONE": 3, "OTHER": 3}
_VERIF = {"Not Verified": 0, "Source Verified": 1, "Verified": 2}
_TERM = {" 36 months": 0, " 60 months": 1, "36 months": 0, "60 months": 1}
_LIST = {"w": 0, "f": 1}
_PURPOSE = {
    "debt_consolidation": 0, "credit_card": 0, "small_business": 1,
    "educational": 2, "car": 3, "other": 3, "vacation": 3, "house": 3,
    "home_improvement": 3, "major_purchase": 3, "medical": 3,
    "renewable_energy": 3, "moving": 3, "wedding": 3,
}
_APP = {"Individual": 0, "Joint App": 1}
_DISB = {"Cash": 0, "DirectPay": 1}
_BAD_LOAN = {
    "Charged Off", "Default",
    "Does not meet the credit policy. Status:Charged Off",
    "In Grace Period", "Late (16-30 days)", "Late (31-120 days)",
}

_CAT_MAPS = {
    "grade": _GRADE, "emp_length": _EMP_LENGTH, "home_ownership": _HOME,
    "verification_status": _VERIF, "term": _TERM,
    "initial_list_status": _LIST, "purpose": _PURPOSE,
    "application_type": _APP, "disbursement_method": _DISB,
}

# party A = qualification + loan features; party B = debt/repayment/
# accounts/behavior (reference loan_load_two_party_data:144-145). The
# numeric members are subsetted to the widely-present loan.csv columns.
PARTY_A_FEATS = [
    "grade", "emp_length", "home_ownership", "annual_inc",
    "verification_status", "loan_amnt", "term", "initial_list_status",
    "purpose", "application_type", "disbursement_method",
]
PARTY_B_FEATS = [
    "int_rate", "installment", "dti", "delinq_2yrs", "open_acc",
    "pub_rec", "revol_bal", "revol_util", "total_acc",
]


def load_lending_club_two_party(
    path: str, n_samples: int = -1, test_fraction: float = 0.2, seed: int = 0
):
    """Two-party Lending Club (reference
    ``loan_load_two_party_data``): categorical columns mapped with the
    reference's maps, numerics coerced (blank -> 0), features standardized;
    target = bad-loan indicator from ``loan_status``
    (``loan_condition``). Returns the same dict shape as
    :func:`load_nus_wide_two_party`."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found (lending club loan.csv)"
        )
    cols = PARTY_A_FEATS + PARTY_B_FEATS
    xs, ys = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            status = row.get("loan_status", "")
            ys.append(1.0 if status in _BAD_LOAN else 0.0)
            feats = []
            for c in cols:
                v = row.get(c, "")
                if c in _CAT_MAPS:
                    feats.append(float(_CAT_MAPS[c].get(v, 0)))
                else:
                    try:
                        feats.append(float(v.rstrip("%")) if v else 0.0)
                    except ValueError:
                        feats.append(0.0)
            xs.append(feats)
            if n_samples != -1 and len(xs) >= n_samples:
                break
    x = _standardize(np.asarray(xs, np.float32))
    y = np.asarray(ys, np.int64)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    n_test = max(1, int(len(x) * test_fraction))
    te, tr = perm[:n_test], perm[n_test:]
    da = len(PARTY_A_FEATS)
    return {
        "train": (x[tr], y[tr]),
        "test": (x[te], y[te]),
        "splits": [(0, da), (da, da + len(PARTY_B_FEATS))],
    }
