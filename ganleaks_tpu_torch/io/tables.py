"""Tabular records from CSV, without pandas or sklearn (the medGAN dataset,
``gan_models/medgan/model.py:107-130``).

* :func:`read_csv_filled`: a CSV with a header row as a float64 matrix,
  every missing field (empty or one of pandas' default NA words) filled
  with its column's median over the present values — ``pd.read_csv(path,
  header=0)`` then ``fillna(df.median())``; blank lines are skipped, as
  pandas does.
* :func:`split_indices`: sklearn's ``train_test_split(test_size=0.1,
  random_state=42)`` with shuffling, in numpy.
* :func:`load_csv_dataset`: the two together, the training rows (the
  member pool) or the held-out 10% (the non-members), float32.
"""

from __future__ import annotations

import io
import math
import os
import re

import numpy as np

# pandas' default NA words (``pandas._libs.parsers.STR_NA_VALUES``) and
# the empty field
_NA = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null")
_NA_FIELD = re.compile(
    r"(?<![^,\n])[ \t]*(?:"
    + "|".join(re.escape(w) for w in sorted(_NA, key=len, reverse=True))
    + r")[ \t]*(?=,|\n)")


def _mark_missing(text: str) -> str:
    """``text`` (lines joined by "\\n", with a trailing one) with every
    missing field written ``nan``. Empty fields, the common case, are
    found by plain string replaces; the regex over every field runs only
    when the text holds a letter, '#', '<' or blanks."""
    if re.search(r"[A-Za-z#< \t]", text):
        return _NA_FIELD.sub("nan", text)
    text = "\n" + text
    while ",," in text:
        text = text.replace(",,", ",nan,")
    return text.replace("\n,", "\nnan,").replace(",\n", ",nan\n")[1:]


def read_csv_filled(path: str) -> np.ndarray:
    """(rows, columns) float64 of a numeric CSV with a header row, missing
    fields filled with the column medians."""
    with open(os.path.expanduser(path)) as f:
        f.readline()
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    text = _mark_missing("\n".join(lines) + "\n")
    data = np.loadtxt(io.StringIO(text), delimiter=",", dtype=np.float64,
                      ndmin=2)
    missing = np.isnan(data)
    if missing.any():
        data[missing] = np.take(np.nanmedian(data, axis=0),
                                np.nonzero(missing)[1])
    return data


def split_indices(n: int, test_size: float = 0.1, seed: int = 42
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices of sklearn's ``train_test_split(...,
    test_size, random_state=seed)`` with shuffling: ``ceil(test_size *
    n)`` test rows, ``perm = RandomState(seed).permutation(n)``, test
    ``perm[:n_test]`` and train ``perm[n_test:]`` in that order."""
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"a {test_size} split of {n} rows leaves an empty "
                         f"side")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def load_csv_dataset(path: str, train: bool = True) -> np.ndarray:
    """The medGAN CSV: median fill, then the 90/10 split; the training
    rows (``train``) or the held-out ones, in the split's order."""
    data = read_csv_filled(path)
    train_idx, test_idx = split_indices(len(data))
    return data[train_idx if train else test_idx].astype(np.float32)
