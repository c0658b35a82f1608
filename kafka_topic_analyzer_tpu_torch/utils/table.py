"""ASCII table renderer byte-compatible with prettytable-rs 0.8 defaults.

The reference renders its per-partition table with ``prettytable-rs``'s
default format (``src/main.rs:148-176``): ``+``/``-`` junction rows around
and *between every* row, ``|`` column separators, one space of padding, and
left-aligned cells.  We hand-roll the same format instead of pulling a Python
table dependency so the output is under our control and locked by golden
tests.
"""

from __future__ import annotations

from typing import List, Sequence


def render_table(rows: Sequence[Sequence[str]]) -> str:
    """Render rows (first row = header) in prettytable-rs default style.

    Returns the table as a string terminated by a newline, e.g.::

        +---+-----+
        | P | Tot |
        +---+-----+
        | 0 | 12  |
        +---+-----+
    """
    if not rows:
        return ""
    ncols = max(len(r) for r in rows)
    widths = [0] * ncols
    norm: List[List[str]] = []
    for row in rows:
        cells = [str(c) for c in row] + [""] * (ncols - len(row))
        norm.append(cells)
        for i, c in enumerate(cells):
            widths[i] = max(widths[i], len(c))

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep]
    for cells in norm:
        line = "| " + " | ".join(c.ljust(widths[i]) for i, c in enumerate(cells)) + " |"
        lines.append(line)
        lines.append(sep)
    return "\n".join(lines) + "\n"
