"""A column table with the few operations of pandas that the experiment
analysis uses, for machines without pandas: ``read_csv``, column and row
access, ``idxmin``/``idxmax``, ``sort_values`` by one key, ``groupby(key)``
with ``mean``, ``std`` and ``head``, and ``to_csv`` in pandas' text format.

Each column is a list of Python or numpy values; a missing value is NaN.
A column's kind follows pandas' inference: bool, int, float32 (every value
a numpy float32), float64 (numbers, NaN allowed: an int column with a
missing value is float64) or object. ``mean`` computes what pandas'
grouped mean computes, a Kahan-compensated sum over the count in the
column's float type, and ``std`` Welford's update in float64 with ddof = 1
(NaN for a group of one), NaN skipped in both: the same bits as pandas
for float64 and int columns, and for the mean of float32 ones. ``read_csv`` parses each number
with ``float``, which reads the shortest round-trip repr exactly (pandas'
default parser can be a unit in the last place off). Rows sort stably,
NaN last; pandas' default sort is not stable, so rows with equal keys may
come out in another order there.
"""

import csv
import math
import re

import numpy as np

NAN = float("nan")
# read_csv's default NA strings, as pandas has them.
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INT = re.compile(r"^[+-]?[0-9]+$")


class EmptyDataError(ValueError):
    """``read_csv`` of a file with nothing to parse."""


def isna(v):
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _is_bool(v):
    return isinstance(v, (bool, np.bool_))


def _is_number(v):
    return (isinstance(v, (int, float, np.integer, np.floating))
            and not _is_bool(v))


def _kind(values):
    """The pandas dtype a column of ``values`` gets: "bool", "int",
    "float32", "float64" or "object"."""
    present = [v for v in values if not isna(v)]
    complete = len(present) == len(values)
    if present and complete and all(_is_bool(v) for v in present):
        return "bool"
    if all(isinstance(v, (int, np.integer)) and not _is_bool(v)
           for v in present):
        return "int" if present and complete else "float64"
    if values and all(isinstance(v, np.float32) for v in values):
        return "float32"
    if all(_is_number(v) for v in present):
        return "float64"
    return "object"


def _formatter(values):
    """How ``to_csv`` writes each value of a column: as pandas does for
    the column's kind (floats as their shortest repr, NaN as an empty
    field)."""
    kind = _kind(values)
    if kind == "int":
        return lambda v: str(int(v))
    if kind == "float32":
        return lambda v: "" if isna(v) else str(np.float32(v))
    if kind == "float64":
        return lambda v: "" if isna(v) else repr(float(v))

    def fmt(v):
        if isna(v):
            return ""
        if isinstance(v, float):
            return repr(v)
        return str(v)
    return fmt


class Row(dict):
    """One row: its values by column name, also as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


class _Positional:
    def __init__(self, get):
        self._get = get

    def __getitem__(self, i):
        return self._get(int(i))


class Column:
    """One column: its ``values`` and the rows' ``index`` labels."""

    def __init__(self, values, index):
        self.values, self.index = list(values), list(index)

    def __iter__(self):
        return iter(self.values)

    def tolist(self):
        return list(self.values)

    @property
    def iloc(self):
        return _Positional(self.values.__getitem__)

    def idxmin(self):
        """The label of the first smallest value, NaN skipped."""
        return self._idx(lambda a, b: a < b)

    def idxmax(self):
        """The label of the first largest value, NaN skipped."""
        return self._idx(lambda a, b: a > b)

    def _idx(self, better):
        best = None
        for label, v in zip(self.index, self.values):
            if not isna(v) and (best is None or better(v, best[1])):
                best = (label, v)
        if best is None:
            raise ValueError("Encountered all NA values")
        return best[0]


class Table:
    """Columns of equal length with row labels (``index``, 0 to n - 1
    unless given). ``data`` is a dict of column name to values, or a list
    of dicts (records: the columns in the order their names first appear,
    a missing value NaN)."""

    def __init__(self, data=None, index=None, index_name=None):
        if isinstance(data, (list, tuple)):
            names = {}
            for rec in data:
                names.update(dict.fromkeys(rec))
            data = {n: [rec.get(n, NAN) for rec in data] for n in names}
        self._cols = {k: list(v) for k, v in (data or {}).items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError("columns of different lengths: %s" % lengths)
        n = lengths.pop() if lengths else 0
        self.index = list(range(n)) if index is None else list(index)
        self.index_name = index_name

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, key):
        if isinstance(key, str):
            return Column(self._cols[key], self.index)
        return Table({k: self._cols[k] for k in key}, self.index,
                     self.index_name)

    def __getattr__(self, name):
        cols = self.__dict__.get("_cols", {})
        if name in cols:
            return self[name]
        raise AttributeError(name)

    def _row(self, i):
        return Row((k, v[i]) for k, v in self._cols.items())

    @property
    def iloc(self):
        return _Positional(self._row)

    def iterrows(self):
        for i, label in enumerate(self.index):
            yield label, self._row(i)

    def _take(self, positions):
        return Table({k: [v[i] for i in positions]
                      for k, v in self._cols.items()},
                     [self.index[i] for i in positions], self.index_name)

    def sort_values(self, by):
        """The rows sorted by the column ``by`` (a name, or a list of
        one), stably, NaN last."""
        if not isinstance(by, str):
            (by,) = by
        vals = self._cols[by]
        order = sorted((i for i, v in enumerate(vals) if not isna(v)),
                       key=vals.__getitem__)
        return self._take(order + [i for i, v in enumerate(vals)
                                   if isna(v)])

    def groupby(self, key):
        return GroupBy(self, key)

    def to_csv(self, path, index=True):
        """The table as pandas writes it: the index (headed by its name)
        as the first column unless ``index`` is False."""
        names = self.columns
        header = ([self.index_name or ""] if index else []) + names
        fmt = [_formatter(self._cols[k]) for k in names]
        index_fmt = _formatter(self.index)
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(header)
            for i, label in enumerate(self.index):
                w.writerow(([index_fmt(label)] if index else [])
                           + [f(self._cols[k][i]) for f, k in zip(fmt, names)])

    def __str__(self):
        names = self.columns
        lines = ["\t".join([self.index_name or ""] + names)]
        for i, label in enumerate(self.index):
            lines.append("\t".join(str(v) for v in [label] + [
                self._cols[k][i] for k in names]))
        return "\n".join(lines)


class GroupBy:
    """The rows of ``table`` grouped by the value of ``key``: the groups
    in sorted key order, rows with a NaN key left out."""

    def __init__(self, table, key):
        self.table, self.key = table, key
        vals = table._cols[key]
        self.groups = {}
        for i, v in enumerate(vals):
            if not isna(v):
                self.groups.setdefault(v, []).append(i)
        self.groups = {k: self.groups[k] for k in sorted(self.groups)}

    def head(self, n):
        """The first ``n`` rows of each group, in the table's order."""
        keep = sorted(i for rows in self.groups.values() for i in rows[:n])
        return self.table._take(keep)

    def mean(self):
        return self._reduce(_mean)

    def std(self):
        """The sample standard deviation (ddof = 1)."""
        return self._reduce(_std)

    def _reduce(self, fn):
        out = {}
        for name, vals in self.table._cols.items():
            if name == self.key:
                continue
            kind = _kind(vals)
            if kind == "object":
                raise TypeError("cannot reduce the non-numeric column %r"
                                % name)
            dtype = np.float32 if kind == "float32" else np.float64
            out[name] = [fn([vals[i] for i in rows], dtype)
                         for rows in self.groups.values()]
        return Table(out, list(self.groups), self.key)


def _mean(values, dtype):
    """pandas' grouped mean: a Kahan-compensated sum over the count."""
    total, comp, n = dtype(0), dtype(0), 0
    for v in values:
        if isna(v):
            continue
        n += 1
        y = dtype(v) - comp
        t = total + y
        comp = t - total - y
        if comp != comp:  # inf - inf
            comp = dtype(0)
        total = t
    return total / n if n else dtype(NAN)


def _std(values, dtype):
    """pandas' grouped std: Welford's update in float64, ddof = 1, the
    result in the column's float type."""
    mean, m2, n = 0.0, 0.0, 0
    for v in values:
        if isna(v):
            continue
        v = float(v)
        n += 1
        old = mean
        mean = mean + (v - old) / n
        m2 = m2 + (v - mean) * (v - old)
    if n <= 1:
        return dtype(NAN)
    return dtype(math.sqrt(m2 / (n - 1)))


def _parse_column(fields):
    """Values of one CSV column, as read_csv types them: int, bool, float
    (NaN for an NA field) or str."""
    na = [f in NA_STRINGS for f in fields]
    present = [f for f, missing in zip(fields, na) if not missing]
    if not present:
        return [NAN] * len(fields)
    if all(_INT.match(f) for f in present):
        if any(na):
            return [NAN if m else float(int(f)) for f, m in zip(fields, na)]
        return [int(f) for f in fields]
    if all(f in _TRUE or f in _FALSE for f in present):
        return [NAN if m else f in _TRUE for f, m in zip(fields, na)]
    try:
        return [NAN if m else float(f) for f, m in zip(fields, na)]
    except ValueError:
        return [NAN if m else f for f, m in zip(fields, na)]


def read_csv(path):
    """A comma-separated file with a header row, read as
    ``pandas.read_csv`` reads it (blank lines skipped, short rows padded
    with NaN)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise EmptyDataError("No columns to parse from file")
    header, body = rows[0], rows[1:]
    return Table({name: _parse_column([r[j] if j < len(r) else ""
                                       for r in body])
                  for j, name in enumerate(header)})
