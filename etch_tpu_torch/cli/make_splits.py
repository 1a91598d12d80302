"""Train/val split generation.

Rebuild of reference `scripts/get_splitted_ids_cape.py:27-49` (subject-level
CAPE split: 12 train / 3 val subjects, id prefix before the first '_') and
`scripts/get_splitted_ids_4d-dress.py` (subject/take table; expressed here as
a generic subject-list mechanism plus ratio subsampling for the
val_ids_sampled_ratio10-style lists).  A copy of `etch_tpu/cli/make_splits.py`
(standard library only); `tests/test_torch_gt_tools.py` holds its pkls
bit-equal to the original's."""

from __future__ import annotations

import argparse
import os
import pickle

CAPE_TRAIN_SUBJECTS = [
    "00032", "00096", "00127", "00134", "00145", "02474",
    "03223", "03284", "03331", "03375", "03383", "03394",
]
CAPE_VAL_SUBJECTS = ["00122", "00159", "00215"]


def subject_of(id_: str) -> str:
    return id_.split("_")[0]


def make_subject_split(scan_dir, smpl_dir, train_subjects, val_subjects):
    train_ids, val_ids = [], []
    for fn in sorted(os.listdir(scan_dir)):
        if not (
            os.path.isdir(os.path.join(scan_dir, fn))
            and os.path.isdir(os.path.join(smpl_dir, fn))
        ):
            continue
        s = subject_of(fn)
        if s in train_subjects:
            train_ids.append(fn)
        elif s in val_subjects:
            val_ids.append(fn)
        else:
            raise ValueError(f"{fn} is not in train or val subjects")
    return train_ids, val_ids


def subsample(ids, ratio: int, seed: int = 420):
    import random

    r = random.Random(seed)
    ids = sorted(ids)
    r.shuffle(ids)
    return sorted(ids[: max(1, len(ids) // ratio)])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scan_dir", type=str, required=True)
    p.add_argument("--smpl_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument(
        "--dataset", type=str, default="cape", choices=["cape", "custom"]
    )
    p.add_argument("--train_subjects", type=str, nargs="*", default=None)
    p.add_argument("--val_subjects", type=str, nargs="*", default=None)
    p.add_argument(
        "--val_sample_ratio", type=int, default=10,
        help="also emit val_ids_sampled_ratio{N}.pkl",
    )
    args = p.parse_args(argv)

    if args.dataset == "cape":
        train_subjects = CAPE_TRAIN_SUBJECTS
        val_subjects = CAPE_VAL_SUBJECTS
    else:
        train_subjects = args.train_subjects or []
        val_subjects = args.val_subjects or []

    train_ids, val_ids = make_subject_split(
        args.scan_dir, args.smpl_dir, set(train_subjects), set(val_subjects)
    )
    print(f"train_ids: {len(train_ids)}")
    print(f"val_ids: {len(val_ids)}")

    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "train_ids.pkl"), "wb") as f:
        pickle.dump(train_ids, f)
    with open(os.path.join(args.save_dir, "val_ids.pkl"), "wb") as f:
        pickle.dump(val_ids, f)
    if args.val_sample_ratio:
        sub = subsample(val_ids, args.val_sample_ratio)
        with open(
            os.path.join(
                args.save_dir, f"val_ids_sampled_ratio{args.val_sample_ratio}.pkl"
            ),
            "wb",
        ) as f:
            pickle.dump(sub, f)


if __name__ == "__main__":
    main()
