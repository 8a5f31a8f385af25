"""Observability: TLC-style action coverage (coverage.py)."""

from .coverage import COLUMNS, dead_actions, render_coverage_table

__all__ = ["COLUMNS", "dead_actions", "render_coverage_table"]
