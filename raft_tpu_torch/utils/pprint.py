"""TLC-style pretty-printing of decoded states and counterexample traces.

Formats states in TLA+ value syntax (records, functions, sequences, bags)
the way TLC prints them in error traces, using the cfg's model-value names
— the human-facing half of "bit-for-bit counterexample parity".
"""

from __future__ import annotations

STATE_NAMES = {0: "Follower", 1: "Candidate", 2: "Leader", 3: "NotMember"}
# decoded fields whose values name a server (or Nil)
SERVER_FIELDS = ("msource", "mdest", "mleader")


def _srv(setup, i) -> str:
    return setup.server_names[i]


def _val(setup, v) -> str:
    return setup.value_names[v]


def _fmt_fun(pairs) -> str:
    return "(" + " @@ ".join(f"{k} :> {v}" for k, v in pairs) + ")"


def _fmt_value(setup, v) -> str:
    """Generic python-value -> TLA+ value syntax (fallback for decoded
    fields the hand-tuned standard-raft path doesn't know: reconfig
    config tuples, KRaft epochs, ...)."""
    if v is None:
        return "Nil"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return v
    if isinstance(v, (frozenset, set)):
        return "{" + ", ".join(sorted(_fmt_value(setup, e) for e in v)) + "}"
    if isinstance(v, tuple):
        return "<<" + ", ".join(_fmt_value(setup, e) for e in v) + ">>"
    try:
        return str(int(v))
    except (TypeError, ValueError):
        return str(v)


def _fmt_entries(setup, entries, key: str) -> str:
    """A log (or a response's entries) of (term or epoch, value) pairs."""
    return "<<" + ", ".join(
        f"[{key} |-> {t}, value |-> {_val(setup, val)}]" for t, val in entries) + ">>"


def _fmt_msg(setup, rec, key: str = "term") -> str:
    """A message record (a sorted tuple of (field, value) pairs); ``key``
    names its entries' term field (KRaft's is ``epoch``)."""
    parts = []
    for k, v in rec:
        if k in SERVER_FIELDS:
            v = "Nil" if v is None else _srv(setup, v)
        elif k == "correlation":  # KRaft: the FetchRequest a response answers
            v = _fmt_msg(setup, v, key)
        elif k == "mlastCommonEntry" and v is not None:  # PullRaft (index, term)
            v = f"[index |-> {v[0]}, term |-> {v[1]}]"
        elif k == "mentries" and all(
            isinstance(e, tuple) and len(e) == 2 for e in v
        ):
            v = _fmt_entries(setup, v, key)
        else:
            v = _fmt_value(setup, v)
        parts.append(f"{k} |-> {v}")
    return "[" + ", ".join(parts) + "]"


def format_state(setup, st: dict) -> str:
    """One decoded state as TLA+ ``/\\ var = value`` lines. The Raft
    family's term is ``currentTerm``; KRaft's is ``currentEpoch``, its log
    entries carry an ``epoch``, and its state names are its model's
    (``STATE_NAMES`` of the setup's model, where it has them)."""
    term = "currentTerm" if "currentTerm" in st else "currentEpoch"
    key = "term" if term == "currentTerm" else "epoch"
    names = getattr(getattr(setup, "model", None), "STATE_NAMES", STATE_NAMES)
    S = len(st[term])
    sv = lambda i: _srv(setup, i)
    lines = []
    handled: set = set()

    def put(name, text):
        handled.add(name)
        lines.append(f"/\\ {name} = {text}")

    put(term, _fmt_fun((sv(i), st[term][i]) for i in range(S)))
    if "state" in st:
        put(
            "state",
            _fmt_fun(
                (sv(i), names.get(st["state"][i], st["state"][i]))
                for i in range(S)
            ),
        )
    for name in ("votedFor", "leader"):  # a server or Nil per server
        if name in st:
            put(
                name,
                _fmt_fun(
                    (sv(i), "Nil" if st[name][i] is None else sv(st[name][i]))
                    for i in range(S)
                ),
            )
    if "pendingFetch" in st:  # KRaft: the outstanding FetchRequest or Nil
        put(
            "pendingFetch",
            _fmt_fun(
                (sv(i), "Nil" if r is None else _fmt_msg(setup, r, key))
                for i, r in enumerate(st["pendingFetch"])
            ),
        )
    if "votesLastEntry" in st:  # PullRaftVariant2: an entry or Nil per voter
        put(
            "votesLastEntry",
            _fmt_fun(
                (
                    sv(i),
                    _fmt_fun(
                        (sv(j), "Nil" if e is None else f"[index |-> {e[0]}, term |-> {e[1]}]")
                        for j, e in enumerate(st["votesLastEntry"][i])
                    ),
                )
                for i in range(S)
            ),
        )
    if "votesGranted" in st:
        put(
            "votesGranted",
            _fmt_fun(
                (sv(i), "{" + ", ".join(sv(j) for j in sorted(st["votesGranted"][i])) + "}")
                for i in range(S)
            ),
        )
    if "log" in st:
        if all(
            isinstance(e, tuple) and len(e) == 2
            for row in st["log"] for e in row
        ):
            put("log", _fmt_fun((sv(i), _fmt_entries(setup, st["log"][i], key))
                                for i in range(S)))
        else:  # reconfig/KRaft entries carry extra fields — generic form
            put(
                "log",
                _fmt_fun(
                    (sv(i), _fmt_value(setup, st["log"][i])) for i in range(S)
                ),
            )
    # commitIndex, KRaft's highWatermark, RaftFsync's fsyncIndex (RaftFsync.tla:92)
    for name in ("commitIndex", "highWatermark", "fsyncIndex"):
        if name in st:
            put(name, _fmt_fun((sv(i), st[name][i]) for i in range(S)))
    for name in ("nextIndex", "matchIndex", "endOffset", "pendingResponse"):
        if name not in st:
            continue
        put(
            name,
            _fmt_fun(
                (
                    sv(i),
                    _fmt_fun(
                        (
                            sv(j),
                            "TRUE"
                            if st[name][i][j] is True
                            else ("FALSE" if st[name][i][j] is False else st[name][i][j]),
                        )
                        for j in range(S)
                    ),
                )
                for i in range(S)
            ),
        )
    if "messages" in st:
        try:
            msgs = sorted(st["messages"])
        except TypeError:  # KRaft records hold None (Nil) beside strings
            msgs = sorted(st["messages"], key=repr)
        put(
            "messages",
            "("
            + " @@ ".join(f"{_fmt_msg(setup, m, key)} :> {c}" for m, c in msgs)
            + ")",
        )
    if "acked" in st:
        put(
            "acked",
            _fmt_fun(
                (
                    _val(setup, v),
                    {None: "Nil", False: "FALSE", True: "TRUE"}[st["acked"][v]],
                )
                for v in range(len(st["acked"]))
            ),
        )
    for name in ("electionCtr", "restartCtr"):
        if name in st:
            put(name, str(st[name]))
    # any remaining decoded variables (reconfig config tuples, counters,
    # KRaft epochs, ...) print via the generic TLA+ value formatter, as
    # a per-server function when server-shaped
    for key, v in st.items():
        if key in handled:
            continue
        if isinstance(v, tuple) and len(v) == S:
            lines.append(
                f"/\\ {key} = "
                + _fmt_fun((sv(i), _fmt_value(setup, v[i])) for i in range(S))
            )
        else:
            lines.append(f"/\\ {key} = {_fmt_value(setup, v)}")
    return "\n".join(lines)


def format_trace(trace, setup) -> str:
    out = []
    for n, (label, st) in enumerate(trace, start=1):
        out.append(f"State {n}: <{label}>")
        out.append(format_state(setup, st))
        out.append("")
    return "\n".join(out)


def format_trace_tlc(trace, setup, violated: str | None = None) -> str:
    """TLC error-trace format (``--trace-format tlc``): the textual shape
    `tlc` prints on an invariant violation, so a counterexample can be
    diffed offline against a real TLC run the day a JVM is available
    (BASELINE.json north-star parity clause; no JVM is in this image).
    Action labels carry the action name and arguments — TLC's labels add
    file line/col spans ("<RequestVote line 253, col 5 ... of module
    Raft>"), which a diff normalizes away; the parity-bearing content is
    the `/\\ var = value` lines."""
    out = []
    if violated is not None:
        out.append(f"Error: Invariant {violated} is violated.")
    out.append("Error: The behavior up to this point is:")
    for n, (label, st) in enumerate(trace, start=1):
        out.append(f"State {n}: <{label}>")
        out.append(format_state(setup, st))
        out.append("")
    return "\n".join(out)


def format_lasso(violation, setup, tlc: bool = False) -> str:
    """A temporal counterexample: the prefix to the loop's entry, then the
    loop (none for a terminal stutter), as the reference's CLI prints it
    (raft_tpu/__main__.py:766-781). TLC prints the lasso as one behavior
    with a "Back to state" marker at the loop entry."""
    out = [format_trace_tlc(violation.prefix, setup, None) if tlc
           else format_trace(violation.prefix, setup)]
    if violation.cycle:
        out.append("-- Back to state: the loop below repeats --" if tlc
                   else "-- loop (repeats forever) --")
        out.append(format_trace(violation.cycle, setup))
    return "\n".join(out)
