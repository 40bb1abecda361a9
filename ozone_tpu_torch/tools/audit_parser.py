"""Audit log parser — the `ozone auditparser` analog.

Port of `ozone_tpu/tools/audit_parser.py`.

The reference loads audit logs into sqlite and runs canned/custom queries
(hadoop-ozone/tools shell `audit/` package: top users, ops by frequency,
failures). Our audit records (utils/audit.py) are JSON lines on the
`audit.<component>` loggers; this parser consumes those files — tolerant
of logging prefixes before the JSON payload — filters, and aggregates.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterator, Optional


def parse_line(line: str) -> Optional[dict]:
    """One audit record from a log line, or None. The JSON payload may be
    preceded by an arbitrary logging prefix (timestamp, level, logger)."""
    i = line.find("{")
    if i < 0:
        return None
    try:
        rec = json.loads(line[i:])
    except ValueError:
        return None
    if not isinstance(rec, dict) or "action" not in rec:
        return None
    return rec


def parse_file(path) -> Iterator[dict]:
    with open(path, "r", errors="replace") as f:
        for line in f:
            rec = parse_line(line)
            if rec is not None:
                yield rec


def filter_records(
    records,
    user: str = "",
    action: str = "",
    result: str = "",
) -> Iterator[dict]:
    for r in records:
        if user and r.get("user") != user:
            continue
        if action and r.get("action") != action:
            continue
        if result and r.get("result") != result:
            continue
        yield r


def aggregate(records, by: str = "action") -> list[dict]:
    """Frequency table over any record field ('action', 'user',
    'result'), most frequent first — the canned top-N queries."""
    counts = Counter(str(r.get(by, "")) for r in records)
    return [{by: k, "count": n} for k, n in counts.most_common()]


def failures(records) -> list[dict]:
    return [r for r in records if r.get("result") == "FAILURE"]


def run_cli(args) -> int:
    """Entry for the `audit` CLI verb."""
    path = Path(args.logfile)
    if not path.exists():
        print(f"error: no such file {path}")
        return 1
    recs = list(
        filter_records(
            parse_file(path),
            user=args.user,
            action=args.action,
            result=args.result,
        )
    )
    if args.verb == "top":
        out = aggregate(recs, by=args.by)[: args.num]
    elif args.verb == "failures":
        out = failures(recs)[-args.num:]
    else:  # parse
        out = recs[-args.num:]
    print(json.dumps(out, indent=2, default=str))
    return 0
