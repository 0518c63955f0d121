"""wire-contract: the frame registry is exhaustively classified.

The protocol surface is 34 frame types across wire v15, and every one
must thread SEVEN independent tables/switches, written in three files:
an encoder (node/protocol.py ``encode_*``), a decoder arm
(``_decode``), a ``_dispatch`` arm (node/node.py), an admission
classification (``_MSG_CLASS`` charge class or the explicit
``_ADMISSION_EXEMPT`` free list — node/governor.py's token buckets
only see what the table names), a SHED keep/drop decision
(``_SHED_DROPS`` / ``_SHED_KEEPS``), a version gate
(``MSG_SINCE``: the wire version that introduced it, ≤
``PROTOCOL_VERSION``), and a relay-byte accounting
family (``_RELAY_ACCOUNTING``: which ``relay.bytes.*`` counter the
frame's egress lands in; an unaccounted frame is bandwidth the
propagation budget can't see, which is exactly the blind spot a
bandwidth-scale relay exists to close).  The historical failure class
is real: successive wire versions each added frame pairs, and "the new frame forgot its
shed/admission classification" survives review precisely because the
omission is INVISIBLE — an unclassified frame silently rides the
default (uncharged, never shed), which is the most permissive
possible reading of a hostile peer's bytes.

This package rule cross-checks the whole surface structurally: it
finds the ``MsgType`` enum, then collects every ``MsgType.X``
reference inside each registry — no imports, no execution — and emits
one finding per hole or contradiction, keyed ``"MEMBER:aspect"``
(``"SNAPSHOT:shed"``), anchored at the member's line in the enum so
the fix starts from the declaration.  Aspects: ``encoder``,
``decoder``, ``dispatch``, ``admission`` (missing from both tables,
or — ``admission-both`` — named in both), ``shed`` /``shed-both``,
``version`` / ``version-future`` (``MSG_SINCE`` entry missing, or
claiming a version newer than ``PROTOCOL_VERSION``), and ``relay``
(no ``_RELAY_ACCOUNTING`` family).

Grants here should be RARE and temporary (a frame mid-introduction
across two commits); the steady state is zero.  The import-time
asserts beside ``_MSG_CLASS``/``_SHED_DROPS`` enforce the
admission/shed halves at runtime too — the rule's extra value is the
encoder/decoder/dispatch/version coverage asserts can't see, and
failing BEFORE the code ever runs.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, dotted_name, register
from p1_tpu_torch.analysis.findings import Finding

_ENUM_BASES = {"IntEnum", "Enum", "enum.IntEnum", "enum.Enum"}


def _msgtype_refs(node: ast.AST) -> set[str]:
    """Every ``MsgType.X`` attribute reference under ``node``."""
    out = set()
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == "MsgType"
        ):
            out.add(sub.attr)
    return out


@register
class WireContractRule(Rule):
    name = "wire-contract"
    title = "frame type missing an encoder/decoder/dispatch/admission/shed/version entry"
    scope = ()  # cross-file by nature; anchors land in node/
    package_rule = True

    def check_package(self, pkg) -> Iterator[Finding]:
        members: dict[str, int] = {}  # name -> lineno
        enum_rel = None
        protocol_version: int | None = None
        encoders: set[str] = set()
        decoders: set[str] = set()
        dispatch: set[str] = set()
        msg_class: set[str] = set()
        exempt: set[str] = set()
        shed_drops: set[str] = set()
        shed_keeps: set[str] = set()
        relay_acct: set[str] = set()
        msg_since: dict[str, tuple[int | None, int]] = {}  # name -> (ver, line)
        have = {
            "_MSG_CLASS": False,
            "_ADMISSION_EXEMPT": False,
            "_SHED_DROPS": False,
            "_SHED_KEEPS": False,
            "_RELAY_ACCOUNTING": False,
            "MSG_SINCE": False,
            "_decode": False,
            "_dispatch": False,
        }

        for rel in sorted(pkg.trees):
            tree = pkg.trees[rel]
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef) and node.name == "MsgType":
                    if any(
                        dotted_name(b) in _ENUM_BASES for b in node.bases
                    ):
                        enum_rel = rel
                        for stmt in node.body:
                            if (
                                isinstance(stmt, ast.Assign)
                                and len(stmt.targets) == 1
                                and isinstance(stmt.targets[0], ast.Name)
                            ):
                                members[stmt.targets[0].id] = stmt.lineno
                elif isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    if node.name.startswith("encode_"):
                        encoders |= _msgtype_refs(node)
                    elif node.name in ("_decode", "decode"):
                        have["_decode"] = True
                        decoders |= _msgtype_refs(node)
                    elif node.name == "_dispatch":
                        have["_dispatch"] = True
                        dispatch |= _msgtype_refs(node)
                elif (
                    isinstance(node, ast.Assign) and len(node.targets) == 1
                ) or (
                    isinstance(node, ast.AnnAssign) and node.value is not None
                ):
                    # Annotated module-level tables (``X: dict = {...}``)
                    # register the same as bare assignments — the relay
                    # table ships annotated, and a rule that only read
                    # ast.Assign would silently go inert on it.
                    tgt = (
                        node.target
                        if isinstance(node, ast.AnnAssign)
                        else node.targets[0]
                    )
                    if not isinstance(tgt, ast.Name):
                        continue
                    if tgt.id == "_MSG_CLASS":
                        have["_MSG_CLASS"] = True
                        msg_class |= _msgtype_refs(node.value)
                    elif tgt.id == "_ADMISSION_EXEMPT":
                        have["_ADMISSION_EXEMPT"] = True
                        exempt |= _msgtype_refs(node.value)
                    elif tgt.id == "_SHED_DROPS":
                        have["_SHED_DROPS"] = True
                        shed_drops |= _msgtype_refs(node.value)
                    elif tgt.id == "_SHED_KEEPS":
                        have["_SHED_KEEPS"] = True
                        shed_keeps |= _msgtype_refs(node.value)
                    elif tgt.id == "_RELAY_ACCOUNTING":
                        have["_RELAY_ACCOUNTING"] = True
                        relay_acct |= _msgtype_refs(node.value)
                    elif tgt.id == "MSG_SINCE":
                        have["MSG_SINCE"] = True
                        self._read_since(node.value, msg_since)
                    elif tgt.id == "PROTOCOL_VERSION" and isinstance(
                        node.value, ast.Constant
                    ):
                        if isinstance(node.value.value, int):
                            protocol_version = node.value.value

        if enum_rel is None or not members:
            return  # no wire surface in this index (fixture mini-packages)

        def finding(member: str, aspect: str, detail: str) -> Finding:
            return Finding(
                file=enum_rel,
                line=members.get(member, 0),
                rule=self.name,
                detail=detail,
                key=f"{member}:{aspect}",
            )

        for m in members:
            if m not in encoders:
                yield finding(
                    m,
                    "encoder",
                    f"MsgType.{m} has no encode_* function — every frame "
                    "type needs a canonical byte producer",
                )
            if have["_decode"] and m not in decoders:
                yield finding(
                    m,
                    "decoder",
                    f"MsgType.{m} has no _decode arm — peers sending it "
                    "get an 'unknown message' protocol error",
                )
            if have["_dispatch"] and m not in dispatch:
                yield finding(
                    m,
                    "dispatch",
                    f"MsgType.{m} has no _dispatch arm — a decoded frame "
                    "with nowhere to go",
                )
            if have["_MSG_CLASS"] and have["_ADMISSION_EXEMPT"]:
                if m not in msg_class and m not in exempt:
                    yield finding(
                        m,
                        "admission",
                        f"MsgType.{m} is in neither _MSG_CLASS nor "
                        "_ADMISSION_EXEMPT — unclassified traffic rides "
                        "free past the governor's budgets",
                    )
                elif m in msg_class and m in exempt:
                    yield finding(
                        m,
                        "admission-both",
                        f"MsgType.{m} is charged by _MSG_CLASS AND "
                        "exempted by _ADMISSION_EXEMPT — pick one",
                    )
            if have["_SHED_DROPS"] and have["_SHED_KEEPS"]:
                if m not in shed_drops and m not in shed_keeps:
                    yield finding(
                        m,
                        "shed",
                        f"MsgType.{m} has no SHED classification — say "
                        "explicitly whether an overloaded node drops or "
                        "serves it (_SHED_DROPS / _SHED_KEEPS)",
                    )
                elif m in shed_drops and m in shed_keeps:
                    yield finding(
                        m,
                        "shed-both",
                        f"MsgType.{m} is in _SHED_DROPS AND _SHED_KEEPS "
                        "— pick one",
                    )
            if have["_RELAY_ACCOUNTING"] and m not in relay_acct:
                yield finding(
                    m,
                    "relay",
                    f"MsgType.{m} has no _RELAY_ACCOUNTING family — "
                    "its egress is invisible to the relay.bytes.* "
                    "propagation budget",
                )
            if have["MSG_SINCE"]:
                since = msg_since.get(m)
                if since is None:
                    yield finding(
                        m,
                        "version",
                        f"MsgType.{m} has no MSG_SINCE entry — record "
                        "the wire version that introduced it",
                    )
                elif (
                    protocol_version is not None
                    and since[0] is not None
                    and since[0] > protocol_version
                ):
                    yield finding(
                        m,
                        "version-future",
                        f"MsgType.{m} claims wire v{since[0]} but "
                        f"PROTOCOL_VERSION is {protocol_version} — "
                        "bump the version with the frame",
                    )
        # dangling entries: registry rows for members the enum lost
        for name, (_, line) in sorted(msg_since.items()):
            if name not in members:
                yield Finding(
                    file=enum_rel,
                    line=line,
                    rule=self.name,
                    detail=(
                        f"MSG_SINCE names MsgType.{name} but the enum "
                        "has no such member — stale registry row"
                    ),
                    key=f"{name}:version-dangling",
                )

    @staticmethod
    def _read_since(
        value: ast.AST, out: dict[str, tuple[int | None, int]]
    ) -> None:
        if not isinstance(value, ast.Dict):
            return
        for k, v in zip(value.keys, value.values):
            if (
                isinstance(k, ast.Attribute)
                and isinstance(k.value, ast.Name)
                and k.value.id == "MsgType"
            ):
                ver = (
                    v.value
                    if isinstance(v, ast.Constant)
                    and isinstance(v.value, int)
                    else None
                )
                out[k.attr] = (ver, k.lineno)
