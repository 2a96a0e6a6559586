"""Pretty-print or convert a steptrace JSONL (counterpart of
``gllm_tpu/obs/dump.py``: ``load_events``, ``format_table``, ``main``).

Usage:
  python -m gllm_tpu_torch.obs.dump trace.jsonl            # table + summary
  python -m gllm_tpu_torch.obs.dump trace.jsonl --summary  # summary only
  python -m gllm_tpu_torch.obs.dump trace.jsonl --format chrome > t.json
                                  # Chrome trace-event JSON (Perfetto)
  python -m gllm_tpu_torch.obs.dump t.jsonl --since 1200 --kind decode,fused_block
  curl -s host:8000/steptrace | python -m gllm_tpu_torch.obs.dump -

The input is one JSON event per line (``StepTrace.to_jsonl``) or a single
JSON object with an ``events`` list (the ``GET /steptrace`` payload).
``--format chrome`` runs the converter ``GET /trace`` uses
(``obs/spans.py`` ``chrome_trace``).
"""

from __future__ import annotations

import argparse
import json
import sys

from gllm_tpu_torch.obs.steptrace import summarize

# ``reason`` is carried by chain_break events (waiting/pages/shape/
# spec/finish/reform); blank for step events
_COLS = ("seq", "t", "kind", "reason", "num_seqs", "tokens", "k",
         "wall_ms")


def load_events(stream) -> list:
    text = stream.read()
    text = text.strip()
    if not text:
        return []
    if text.startswith("{") and "\n" not in text.split("}", 1)[0]:
        try:
            obj = json.loads(text)
            if isinstance(obj, dict) and "events" in obj:
                return obj["events"]
        except json.JSONDecodeError:
            pass
    events = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            events.append(json.loads(line))
    return events


def format_table(events: list) -> str:
    rows = [[str(e.get(c, "")) for c in _COLS] for e in events]
    widths = [max([len(c)] + [len(r[i]) for r in rows])
              for i, c in enumerate(_COLS)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(_COLS, widths))]
    for r in rows:
        lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gllm_tpu_torch.obs.dump",
        description="pretty-print or convert a steptrace JSONL")
    ap.add_argument("path", help="JSONL file, or - for stdin")
    ap.add_argument("--summary", action="store_true",
                    help="print only the by-kind wall-time summary")
    ap.add_argument("--format", choices=("table", "chrome"),
                    default="table",
                    help="chrome: emit Chrome trace-event JSON "
                         "(Perfetto-loadable; the GET /trace converter)")
    ap.add_argument("--since", type=int, default=0,
                    help="drop events whose ring seq is below this")
    ap.add_argument("--kind", default=None,
                    help="comma-separated event kinds to keep")
    args = ap.parse_args(argv)
    if args.path == "-":
        events = load_events(sys.stdin)
    else:
        with open(args.path) as f:
            events = load_events(f)
    if args.since:
        events = [e for e in events if e.get("seq", 0) >= args.since]
    if args.kind:
        keep = {k for k in args.kind.split(",") if k}
        events = [e for e in events if e.get("kind") in keep]
    if args.format == "chrome":
        from gllm_tpu_torch.obs.spans import chrome_trace
        print(json.dumps(chrome_trace(events)))
        return 0
    if not args.summary:
        print(format_table(events))
        print()
    print(json.dumps(summarize(events), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
