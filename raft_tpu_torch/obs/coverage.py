"""TLC-style action coverage: the ``--coverage`` table and dead actions.

The port's own copy of raft_tpu/obs/coverage.py (render_coverage_table,
dead_actions). The input is the per-action counter block the BFS
accumulates, ``coverage[rank] = [enabled, fired, new_distinct]`` with
``rank`` indexing the model's ``ACTION_NAMES`` (the Next-disjunct order):

  enabled       (state, action) pairs where the disjunct's guard held on a
                live frontier state
  fired         successors the rank generated (every valid candidate lane,
                before dedup)
  new_distinct  distinct states the rank reached first (after dedup and
                symmetry)

TLC's ``-coverage`` prints fired/distinct per action; ``enabled`` tells a
disjunct whose guard never holds (a model-scale artifact) from one that
is enabled but never fires (a lowering fault). Dependency-free.
"""

from __future__ import annotations

COLUMNS = ("enabled", "fired", "new distinct")


def _rows(action_names, actions) -> list[tuple[str, int, int, int]]:
    names = list(action_names)
    return [(names[r] if r < len(names) else f"action[{r}]", int(row[0]), int(row[1]),
             int(row[2])) for r, row in enumerate(actions)]


def dead_actions(action_names, actions) -> list[str]:
    """Names of the actions that never fired (fired == 0), in rank order."""
    return [name for name, _e, f, _n in _rows(action_names, actions) if f == 0]


def render_coverage_table(action_names, actions, title: str | None = None) -> str:
    """The end-of-run ``--coverage`` table, one row per Next disjunct, with
    a WARNING line per action that never fired."""
    rows = _rows(action_names, actions)
    lines = [title or "Action coverage (cumulative over the run):"]
    if not rows:
        lines.append("  (no per-action coverage recorded)")
        return "\n".join(lines)
    wname = max(len("action"), max(len(r[0]) for r in rows))
    lines.append(f"  {'action':<{wname}}" + "".join(f"  {c:>12}" for c in COLUMNS))
    for name, e, f, n in rows:
        lines.append(f"  {name:<{wname}}  {e:>12}  {f:>12}  {n:>12}")
    for name in dead_actions(action_names, actions):
        lines.append(f"WARNING: action {name} never fired")
    return "\n".join(lines)
