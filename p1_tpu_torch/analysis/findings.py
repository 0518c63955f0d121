"""The unit of output: one structural violation at one source line."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Finding:
    """One rule hit.

    ``file`` is the path relative to the analyzed package root with
    POSIX separators ("node/node.py") — the same spelling the
    allowlists use.  ``key`` is the rule-defined grant key (the
    *construct*, not the instance): the wall-clock rule keys on the
    dotted callable ("time.monotonic"), the lost-task rule on the
    enclosing function, the await-state rule on the attribute name.
    Grants therefore survive line churn but never outlive the construct
    they bless — the stale-grant check fails any grant no finding
    consumes.
    """

    file: str
    line: int
    rule: str
    detail: str
    key: str

    def __str__(self) -> str:  # the human CLI line
        return f"{self.file}:{self.line}: [{self.rule}] {self.detail}"
