"""Shared helpers of the experiment CLIs: absl-style flags on ``argparse``,
pandas-equal CSV files on ``csv``, and pandas-equal group statistics.

The experiment CLIs of ``experiments/`` read their flags with absl and write
their tables with pandas; the port keeps their command lines and their files
with the standard library alone:

* ``FlagParser`` reads the command lines absl reads: ``--name value``,
  ``--name=value``, and for booleans ``--x``, ``--nox``, ``--x=true`` and
  ``--x=false`` (absl's ``t``/``f``/``1``/``0`` too, in any case). Its
  values have absl's types: ``int`` for an integer flag, ``float`` for a
  float flag even when the user types ``1``, ``bool`` and ``str``; so a
  dict of them hashes as absl's does (``utils.experiment.hash_dict``).
* ``write_csv(rows, path)`` writes the bytes of
  ``pd.DataFrame(rows).to_csv(path, index=False)``: the columns in
  first-seen order, a missing or NaN value as an empty field, and each
  column formatted as pandas formats the dtype it would infer (float64,
  float32, int64, bool or object).
* ``group_stats`` gives the numbers of ``groupby(keys).agg(...)`` with
  ``mean``, ``std`` (the sample std, ddof=1) and ``count``, NaN skipped,
  summed in pandas' own orders (compensated sums for the mean, Welford's
  updates for the std), and ``format_table`` prints them as a table.
"""

import argparse
import csv
import io
import math
import sys
from typing import NamedTuple

import numpy as np

_TRUE = ("true", "t", "1")
_FALSE = ("false", "f", "0")


class Outcome(NamedTuple):
    """What a sweep's ``main`` returns: its rows, the cells recorded as failed
    (NaN rows, or trials marked ERROR), and the groups that fell back from a
    stacked fit to sequential runs."""
    rows: list
    failed: int
    fell_back: int


def _absl_int(text):
    """absl's integer parser: decimal, or 0x / 0o prefixed."""
    base = 10
    if len(text) > 2 and text[0] == "0":
        if text[1] == "o":
            base = 8
        elif text[1] in "xX":
            base = 16
    return int(text, base)


def _absl_bool(text):
    low = text.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"Non-boolean argument to boolean flag: {text!r}")


class FlagParser(argparse.ArgumentParser):
    """An ``argparse`` parser that takes absl's command-line forms and types.

    ``flag_types`` maps each flag's name to absl's type name ('string',
    'int', 'float' or 'bool'), so its flags can be listed as absl lists them.
    """

    def __init__(self, description=None):
        super().__init__(description=description, allow_abbrev=False)
        self.flag_types = {}

    def _define(self, name, kind, **kw):
        self.flag_types[name] = kind
        self.add_argument(f"--{name}", dest=name, **kw)

    def string(self, name, default, help):
        self._define(name, "string", type=str, default=default, help=help)

    def integer(self, name, default, help):
        self._define(name, "int", type=_absl_int, default=int(default), help=help)

    def real(self, name, default, help):
        self._define(name, "float", type=float, default=float(default), help=help)

    def boolean(self, name, default, help):
        self.flag_types[name] = "bool"
        self.add_argument(f"--{name}", dest=name, action="store_true", default=bool(default),
                          help=f"{help} (--no{name} to unset)")
        self.add_argument(f"--no{name}", dest=name, action="store_false",
                          help=argparse.SUPPRESS)

    def set_default(self, name, value):
        """absl's ``FLAGS.set_default``: a new default for a defined flag."""
        self.set_defaults(**{name: value})

    def parse(self, argv=None):
        """The flags' values from ``argv`` (the arguments after the program's
        name; None: ``sys.argv[1:]``)."""
        argv = list(sys.argv[1:] if argv is None else argv)
        out = []
        for arg in argv:
            name, eq, value = arg[2:].partition("=")
            if arg.startswith("--") and eq and self.flag_types.get(name) == "bool":
                try:
                    arg = f"--{name}" if _absl_bool(value) else f"--no{name}"
                except argparse.ArgumentTypeError as e:
                    self.error(str(e))
            out.append(arg)
        return self.parse_args(out)


def int_list(text):
    return [int(s) for s in text.split(",")]


# ----------------------------------------------------------------- csv


def missing(v):
    """Whether a cell is absent: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _kind(v):
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, np.floating) and not isinstance(v, np.float64):
        return np.dtype(type(v)).name
    if isinstance(v, (float, np.floating)):
        return "float64"
    return "object"


def _column_cells(values):
    """One column's cells as ``DataFrame(rows).to_csv`` writes them: the dtype
    pandas infers from the values (None where a row lacks the key), then that
    dtype's text."""
    kinds = {None if v is None else _kind(v) for v in values}
    floats = kinds - {None, "bool", "int", "object"}
    if kinds <= {"bool"}:
        return [str(bool(v)) for v in values]
    if kinds <= {"int"}:
        return [str(int(v)) for v in values]
    if len(floats) == 1 and kinds == floats and "float64" not in floats:
        # one narrower float dtype throughout (its own NaN included) stays that dtype
        return ["" if v != v else str(v) for v in values]
    if kinds and kinds <= {None, "int", "float64"} | floats:
        if kinds == {None}:
            return ["" for _ in values]
        return ["" if missing(v) else str(np.float64(v)) for v in values]
    return ["" if missing(v) else str(v) for v in values]


def csv_text(rows):
    """The text of ``pd.DataFrame(rows).to_csv(index=False)``."""
    columns = []
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    cells = [_column_cells([row.get(k) for row in rows]) for k in columns]
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n", delimiter=",", quotechar='"',
                        quoting=csv.QUOTE_MINIMAL, doublequote=True)
    writer.writerow([str(c) for c in columns])
    for i in range(len(rows)):
        writer.writerow([col[i] for col in cells])
    return buf.getvalue()


def write_csv(rows, path):
    """Write ``rows`` (a list of dicts) as ``pd.DataFrame(rows).to_csv(path,
    index=False)`` would."""
    with open(path, "w", newline="") as f:
        f.write(csv_text(rows))


_POW10 = [float(f"1e{k}") for k in range(309)]
_SPECIAL = {"": math.nan, "nan": math.nan, "inf": math.inf, "+inf": math.inf,
            "-inf": -math.inf, "infinity": math.inf, "-infinity": -math.inf}


def _pandas_float(text):
    """A decimal as ``pd.read_csv``'s default converter reads it (its C
    ``precise_xstrtod``): up to 17 significant digits gathered in a double,
    then scaled by one power of ten, which can differ from the correctly
    rounded value by an ulp."""
    i, n = 0, len(text)
    negative = text[:1] == "-"
    i += text[:1] in "+-" and n > 0
    number, exponent, digits, seen = 0.0, 0, 0, False
    while i < n and text[i].isdigit():
        if digits < 17:
            number = number * 10.0 + int(text[i])
            digits += 1
        else:
            exponent += 1
        i, seen = i + 1, True
    if i < n and text[i] == ".":
        i += 1
        decimals = 0
        while i < n and text[i].isdigit():
            if digits < 17:
                number = number * 10.0 + int(text[i])
                digits += 1
                decimals += 1
            i, seen = i + 1, True
        exponent -= decimals
    if not seen:
        raise ValueError(text)
    if i < n and text[i] in "eE":
        sign, i = (-1 if text[i + 1:i + 2] == "-" else 1), i + 1
        i += text[i:i + 1] in "+-"
        if i >= n or not text[i:].isdigit():
            raise ValueError(text)
        exponent += sign * int(text[i:])
        i = n
    if i != n:
        raise ValueError(text)
    if exponent > 308:
        number = math.inf
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if negative else number


def _number(text):
    """A CSV cell as ``pd.read_csv`` reads a numeric column's: an int, else
    its float converter's value ('' is NaN)."""
    special = _SPECIAL.get(text.lower())
    if special is not None:
        return special
    try:
        return int(text)
    except ValueError:
        return _pandas_float(text)


def read_csv(path):
    """The rows of a CSV file as dicts; cells that read as numbers are numbers
    ('' is NaN), the rest strings."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = []
        for cells in reader:
            row = {}
            for name, cell in zip(header, cells):
                try:
                    row[name] = _number(cell)
                except ValueError:
                    row[name] = cell
            rows.append(row)
    return rows


# ----------------------------------------------------------------- group statistics


def _mean(values):
    """pandas' group mean: a compensated (Kahan) sum over the non-NaN values."""
    total = comp = 0.0
    n = 0
    for v in values:
        if v != v:
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / n if n else math.nan


def _std(values, ddof=1):
    """pandas' group std: Welford's running mean and sum of squares over the
    non-NaN values, NaN where at most ``ddof`` of them remain."""
    mean = m2 = 0.0
    n = 0
    for v in values:
        if v != v:
            continue
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (n - ddof)) if n > ddof else math.nan


_AGG = {"mean": _mean, "std": _std, "pstd": lambda values: _std(values, ddof=0),
        "count": lambda values: sum(1 for v in values if v == v)}


def group_stats(rows, keys, aggs):
    """pandas' ``groupby(keys).agg(**{out: (column, func)})`` for ``func`` in
    mean / std / count, and 'pstd' the population std (ddof=0): [(key tuple,
    {out: value})] in sorted key order, rows whose key holds a NaN left out."""
    groups = {}
    for row in rows:
        key = tuple(row.get(k, math.nan) for k in keys)
        if any(missing(k) for k in key):
            continue
        groups.setdefault(key, []).append(row)
    out = []
    for key in sorted(groups):
        members = groups[key]
        out.append((key, {name: _AGG[func]([float(r.get(col, math.nan))
                                            if not missing(r.get(col)) else math.nan
                                            for r in members])
                          for name, (col, func) in aggs.items()}))
    return out


def _format_column(values):
    """pandas' display of a float column: six decimals, trailing zeros trimmed
    while every value has one, NaN as 'NaN'."""
    if all(isinstance(v, int) for v in values):
        return [str(v) for v in values]
    finite = [abs(v) for v in values if v == v and not math.isinf(v)]
    if any(v >= 1e6 for v in finite) or any(0 < v < 1e-6 for v in finite):
        return ["NaN" if v != v else f"{v:.6e}" for v in values]
    text = ["NaN" if v != v else f"{float(v):.6f}" for v in values]
    while any(t != "NaN" for t in text) and all(
            t == "NaN" or (t.endswith("0") and not t.endswith(".0")) for t in text):
        text = [t if t == "NaN" else t[:-1] for t in text]
    return text


def format_table(index_names, header_rows, table):
    """A table laid out as pandas prints a grouped frame: ``header_rows`` of
    column labels (one row of names, or two for (column, statistic) pairs),
    the index names on a line of their own, then one line a group.
    ``table`` is [(key tuple, [values])]."""
    n_cols = len(header_rows[-1])
    keys = [[str(k) for k in key] for key, _ in table]
    cols = [_format_column([vals[j] for _, vals in table]) for j in range(n_cols)]
    widths = [max([len(h[j]) for h in header_rows] + [len(c) for c in cols[j]])
              for j in range(n_cols)]
    key_w = [max([len(index_names[i])] + [len(k[i]) for k in keys])
             for i in range(len(index_names))]
    pad = " ".join(" " * w for w in key_w)
    lines = []
    for header in header_rows:
        lines.append(pad + "".join("  " + h.rjust(w) for h, w in zip(header, widths)))
    lines.append(" ".join(n.ljust(w) for n, w in zip(index_names, key_w)))
    for key, i in zip(keys, range(len(table))):
        lines.append(" ".join(k.ljust(w) for k, w in zip(key, key_w))
                     + "".join("  " + cols[j][i].rjust(widths[j]) for j in range(n_cols)))
    return "\n".join(lines)
