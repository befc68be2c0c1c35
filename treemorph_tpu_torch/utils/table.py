"""A small column table: the port's stand-in for the pandas DataFrames that
``treemorph_tpu`` builds from lists of row dicts (cylinder exports,
synthetic QSMs).

Columns are typed the way ``pandas.DataFrame(records)`` types them, and
:meth:`Table.to_csv` writes the bytes ``DataFrame.to_csv(index=False)``
writes: float64 in shortest round-trip form, missing values as empty
fields, other objects through ``str``, quoting as the ``csv`` module's
QUOTE_MINIMAL, ``\\n`` line ends. :meth:`Table.read_csv` reads such a file
back as ``pandas.read_csv`` types it (int64 where every field is an
integer, float64 where every field is a number or empty, strings else),
its header names stripped and unquoted as the JAX package's label
generation cleans them.
"""

from __future__ import annotations

import csv
import numbers

import numpy as np


def _column(values: list):
    """Numpy column typed like pandas' inference over a record column."""
    present = [v for v in values if v is not None]
    if not present:
        return np.array(values, dtype=object)
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        if len(present) == len(values):
            return np.array(values, dtype=bool)
        return np.array(values, dtype=object)
    numeric = all(
        isinstance(v, numbers.Real) and not isinstance(v, (bool, np.bool_))
        for v in present
    )
    if numeric:
        if len(present) == len(values) and all(
            isinstance(v, numbers.Integral) for v in present
        ):
            return np.array(values, dtype=np.int64)
        return np.array(
            [np.nan if v is None else v for v in values], dtype=np.float64
        )
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _parse_column(fields: list[str]) -> np.ndarray:
    """A CSV column typed as pandas types it."""
    try:
        return np.array([int(f) for f in fields], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(f) if f.strip() else np.nan for f in fields],
                        dtype=np.float64)
    except ValueError:
        pass
    out = np.empty(len(fields), dtype=object)
    out[:] = fields
    return out


class Table:
    """Ordered mapping of column name to a 1-D numpy column."""

    def __init__(self, columns: dict[str, np.ndarray]):
        self._cols = dict(columns)
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")

    @classmethod
    def from_records(cls, records: list[dict], columns=None) -> "Table":
        if columns is None:
            columns = []
            for rec in records:
                columns.extend(k for k in rec if k not in columns)
        return cls({
            name: _column([rec.get(name) for rec in records])
            for name in columns
        })

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        """The table of a CSV file with a header row."""
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError(f"{path}: no header row")
        names = [n.strip().replace('"', "") for n in rows[0]]
        body = rows[1:]
        if any(len(r) != len(names) for r in body):
            raise ValueError(f"{path}: rows differ in length from the "
                             f"header's {len(names)} fields")
        return cls({name: _parse_column([r[i] for r in body])
                    for i, name in enumerate(names)})

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def to_numpy(self, names, dtype=np.float64) -> np.ndarray:
        """(rows, len(names)) array of the named columns."""
        return np.stack(
            [np.asarray(self._cols[n], dtype) for n in names], axis=1
        )

    def to_csv(self, path: str) -> None:
        """Write the table as ``DataFrame.to_csv(path, index=False)`` does."""
        cells = []
        for col in self._cols.values():
            if col.dtype.kind == "f":
                text = col.astype(str).astype(object)
                text[np.isnan(col)] = ""
            else:
                text = np.array(
                    ["" if v is None else str(v) for v in col], dtype=object
                )
            cells.append(text)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            for row in zip(*cells):
                writer.writerow(row)
