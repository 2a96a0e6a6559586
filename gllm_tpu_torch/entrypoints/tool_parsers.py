"""Model-native tool-call markup → OpenAI ``tool_calls`` (counterpart of
``gllm_tpu/entrypoints/tool_parsers.py``, a copy).

Per-model-family parsers that extract tool invocations from generated
text, with schema-driven argument type coercion, plus auto-detection from
the model name (the reference's api_server.py:543-575).

Formats:
- ``qwen`` (hermes-style, Qwen/Qwen2.5/Qwen3):
  ``<tool_call>\\n{"name": ..., "arguments": {...}}\\n</tool_call>``
- ``qwen3.5`` (XML form the Qwen3.5 hybrids natively emit):
  ``<tool_call><function=NAME><parameter=ARG>VALUE</parameter>...
  </function></tool_call>``
- ``deepseek`` (DeepSeek V3-family unicode-fenced sections):
  ``<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>NAME<｜tool▁sep｜>JSON
  <｜tool▁call▁end｜>...<｜tool▁calls▁end｜>``
"""

from __future__ import annotations

import dataclasses
import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: str              # JSON-encoded string (OpenAI wire format)
    id: str = ""

    def to_openai(self) -> dict:
        return {
            "id": self.id or f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


def coerce_arguments(args: Dict[str, Any],
                     schema: Optional[dict]) -> Dict[str, Any]:
    """Schema-driven argument type coercion (reference tool_parsers.py):
    models emit numbers/bools as strings; fix them up against the declared
    parameter types."""
    if not schema:
        return args
    props = schema.get("properties", {})
    out = {}
    for k, v in args.items():
        typ = props.get(k, {}).get("type")
        try:
            if typ == "integer" and isinstance(v, str):
                v = int(v)
            elif typ == "number" and isinstance(v, str):
                v = float(v)
            elif typ == "boolean" and isinstance(v, str):
                v = v.strip().lower() in ("true", "1", "yes")
            elif typ in ("object", "array") and isinstance(v, str):
                v = json.loads(v)
        except (ValueError, json.JSONDecodeError):
            pass
        out[k] = v
    return out


class ToolParser:
    """Base: no tool support — everything is content."""

    #: literal strings whose appearance means tool markup is starting;
    #: the streaming adapter holds back only potential-marker suffixes.
    STREAM_MARKERS: Tuple[str, ...] = ()
    #: literal strings that terminate one call unit; the streaming adapter
    #: only re-parses when a NEW end marker arrives, so per-call work is
    #: O(unit) once instead of O(unit) per token.
    END_MARKERS: Tuple[str, ...] = ()

    def parse(self, text: str,
              schemas: Optional[Dict[str, dict]] = None
              ) -> Tuple[str, List[ToolCall]]:
        return text, []

    def completed_calls(self, text: str,
                        schemas: Optional[Dict[str, dict]] = None
                        ) -> Tuple[List[ToolCall], int]:
        """(calls, consumed) for the streaming adapter: calls whose markup
        is COMPLETE in ``text`` (which may end mid-markup), plus the char
        offset past the last complete unit so the caller never re-parses
        emitted markup. Default: a full parse, nothing consumed."""
        return self.parse(text, schemas)[1], 0


class QwenToolParser(ToolParser):
    _RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
    STREAM_MARKERS = ("<tool_call>",)
    END_MARKERS = ("</tool_call>",)

    def parse(self, text, schemas=None):
        calls: List[ToolCall] = []

        def repl(match):
            try:
                obj = json.loads(match.group(1))
            except json.JSONDecodeError:
                return match.group(0)  # leave malformed markup as content
            name = obj.get("name", "")
            args = obj.get("arguments", {})
            if isinstance(args, dict) and schemas:
                args = coerce_arguments(args, schemas.get(name))
            calls.append(ToolCall(name=name, arguments=json.dumps(
                args, ensure_ascii=False)))
            return ""

        content = self._RE.sub(repl, text).strip()
        return content, calls

    def completed_calls(self, text, schemas=None):
        calls, end = [], 0
        for m in self._RE.finditer(text):
            try:
                obj = json.loads(m.group(1))
            except json.JSONDecodeError:
                # Malformed unit: stop consuming HERE so `end` never
                # advances past it — the markup stays in the buffer for
                # finish() to surface as content, matching the
                # non-streaming parse() (a later valid unit must not
                # swallow it).
                break
            args = obj.get("arguments", {})
            name = obj.get("name", "")
            if isinstance(args, dict) and schemas:
                args = coerce_arguments(args, schemas.get(name))
            calls.append(ToolCall(name=name, arguments=json.dumps(
                args, ensure_ascii=False)))
            end = m.end()
        return calls, end


class Qwen3XmlToolParser(ToolParser):
    """Qwen3.5 native XML tool markup (reference tool_parsers.py:346-425):

    ``<tool_call>\\n<function=NAME>\\n<parameter=ARG>\\nVALUE\\n</parameter>
    ...\\n</function>\\n</tool_call>``

    Parameter values arrive as raw text with no type information; they are
    type-corrected against the declared JSON schema via
    :func:`coerce_arguments` — ``string`` params stay strings (schema-less
    ``json.loads`` on every value would break BFCL's string-typed
    categories), everything else is coerced to its declared type.

    Robustness choices mirrored from the reference: a value runs until its
    ``</parameter>``, the next ``<parameter=``, or the end of the function
    body (the model sometimes drops the final closing tag); ``<function=``
    blocks are scanned in the whole text so a garbled ``</tool_call>``
    does not hide calls. Deviation: we also treat a bare ``<function=``
    (no enclosing ``<tool_call>``) as tool markup, so the streaming
    adapter never leaks half a call as content."""

    _FUNC = re.compile(r"<function=(?P<name>[^>\n]+)>(?P<body>.*?)"
                       r"</function>", re.DOTALL)
    _PARAM = re.compile(r"<parameter=(?P<key>[^>\n]+)>(?P<val>.*?)"
                        r"(?:</parameter>|(?=<parameter=)|\Z)", re.DOTALL)
    STREAM_MARKERS = ("<tool_call>", "<function=")
    # One call unit is complete at </function> — before the trailing
    # </tool_call> ever arrives, so streamed calls surface a token early.
    END_MARKERS = ("</function>",)

    def _call_from(self, m: "re.Match", schemas) -> Optional[ToolCall]:
        name = m.group("name").strip()
        if not name:
            return None
        args = {k: v for k, v in
                ((pm.group("key").strip(), pm.group("val").strip())
                 for pm in self._PARAM.finditer(m.group("body"))) if k}
        if schemas:
            args = coerce_arguments(args, schemas.get(name))
        return ToolCall(name=name,
                        arguments=json.dumps(args, ensure_ascii=False))

    _BLOCK = re.compile(r"<tool_call>\s*(?:<function=.*?</function>\s*)*"
                        r"(?:</tool_call>)?|<function=.*?</function>"
                        r"|</tool_call>",   # orphaned closer (interleaved
                        re.DOTALL)          # text split it from its opener)

    def parse(self, text, schemas=None):
        calls = [c for c in (self._call_from(m, schemas)
                             for m in self._FUNC.finditer(text)) if c]
        if not calls:
            # Prose that merely mentions the markup (or malformed markup)
            # passes through untouched, like the hermes parser.
            return text, []
        # Remove only the matched markup; assistant text before, between,
        # and after the calls survives (the reference keeps only the
        # prefix — ours deliberately preserves trailing text too, matching
        # our hermes behavior and its streaming finish() contract).
        return self._BLOCK.sub("", text).strip(), calls

    def completed_calls(self, text, schemas=None):
        calls, end = [], 0
        for m in self._FUNC.finditer(text):
            c = self._call_from(m, schemas)
            if c:
                calls.append(c)
            end = m.end()
        return calls, end


class DeepSeekToolParser(ToolParser):
    _BLOCK = re.compile(
        r"<｜tool▁calls▁begin｜>(.*?)<｜tool▁calls▁end｜>", re.DOTALL)
    _CALL = re.compile(
        r"<｜tool▁call▁begin｜>(.*?)<｜tool▁sep｜>(.*?)<｜tool▁call▁end｜>",
        re.DOTALL)
    STREAM_MARKERS = ("<｜tool▁calls▁begin｜>", "<｜tool▁call▁begin｜>")
    END_MARKERS = ("<｜tool▁call▁end｜>",)

    @staticmethod
    def _strip_fence(payload: str) -> str:
        payload = payload.strip()
        if payload.startswith("```json"):
            payload = payload[7:]
        elif payload.startswith("```"):
            payload = payload[3:]
        return payload.strip().rstrip("`").strip()

    def _parse_call(self, head: str, body: str, schemas) -> ToolCall:
        head = head.strip()
        body = body.strip()
        # Two layouts in the wild:
        #   stock V3/R1 template: head == "function",
        #     body == "NAME\n```json\nARGS\n```"
        #   simplified:           head == NAME, body == ARGS-json
        if head == "function" or "```" in body:
            name, _, fenced = body.partition("\n")
            name = name.strip()
            payload = self._strip_fence(fenced)
        else:
            name = head
            payload = self._strip_fence(body)
        try:
            args = json.loads(payload) if payload else {}
        except json.JSONDecodeError:
            args = {}
        if schemas:
            args = coerce_arguments(args, schemas.get(name))
        return ToolCall(name=name,
                        arguments=json.dumps(args, ensure_ascii=False))

    def parse(self, text, schemas=None):
        calls: List[ToolCall] = []

        def repl(match):
            for head, body in self._CALL.findall(match.group(1)):
                calls.append(self._parse_call(head, body, schemas))
            return ""

        content = self._BLOCK.sub(repl, text).strip()
        return content, calls

    def completed_calls(self, text, schemas=None):
        # Per-call units complete before the section end marker arrives.
        calls, end = [], 0
        for m in self._CALL.finditer(text):
            calls.append(self._parse_call(m.group(1), m.group(2), schemas))
            end = m.end()
        return calls, end


class KimiToolParser(ToolParser):
    """Kimi K2/K2.5 markup (reference tool_parsers.py:429-481):

    ``<|tool_calls_section_begin|>`` wraps the calls; each call is
    ``<|tool_call_begin|>functions.NAME:IDX<|tool_call_argument_begin|>
    JSON<|tool_call_end|>``."""

    _SECTION = "<|tool_calls_section_begin|>"
    _CALL = re.compile(
        r"<\|tool_call_begin\|>\s*([^\s<]+?)\s*"
        r"<\|tool_call_argument_begin\|>\s*(.*?)\s*<\|tool_call_end\|>",
        re.DOTALL)
    STREAM_MARKERS = (_SECTION,)
    END_MARKERS = ("<|tool_call_end|>",)

    @staticmethod
    def _name_from_id(fid: str) -> str:
        # ids look like "functions.get_weather:0"
        fid = fid.split(":", 1)[0]
        return fid[len("functions."):] if fid.startswith("functions.") \
            else fid

    def parse(self, text, schemas=None):
        if self._SECTION not in text:
            return text, []
        calls: List[ToolCall] = []
        for fid, payload in self._CALL.findall(text):
            name = self._name_from_id(fid.strip())
            if not name:
                continue
            try:
                args = json.loads(payload) if payload.strip() else {}
            except json.JSONDecodeError:
                args = {}
            if isinstance(args, dict) and schemas:
                args = coerce_arguments(args, schemas.get(name))
            calls.append(ToolCall(name=name, arguments=json.dumps(
                args, ensure_ascii=False)))
        content = text.split(self._SECTION, 1)[0].strip()
        return content, calls

    def completed_calls(self, text, schemas=None):
        calls, end = [], 0
        for m in self._CALL.finditer(text):
            name = self._name_from_id(m.group(1).strip())
            if not name:
                continue
            payload = m.group(2)
            try:
                args = json.loads(payload) if payload.strip() else {}
            except json.JSONDecodeError:
                args = {}
            if isinstance(args, dict) and schemas:
                args = coerce_arguments(args, schemas.get(name))
            calls.append(ToolCall(name=name, arguments=json.dumps(
                args, ensure_ascii=False)))
            end = m.end()
        return calls, end


class StreamingToolCalls:
    """Incremental SSE adapter over a ToolParser (role of the reference's
    streaming tool parsers, tool_parsers.py — ours completes per call-unit
    rather than per argument token). Text deltas pass through immediately;
    only a trailing fragment that could begin tool markup is held back.
    Once markup starts, each completed call is emitted as the standard
    OpenAI delta pair (id+name, then the full arguments string)."""

    def __init__(self, parser: ToolParser,
                 schemas: Optional[Dict[str, dict]] = None):
        self.parser = parser
        self.schemas = schemas or {}
        self.buf = ""
        self.in_tool = False
        self.n_emitted = 0
        self._done = 0       # buf offset past already-emitted call units
        self._scanned = 0    # buf offset end-marker search has covered

    def _held_suffix_len(self) -> int:
        """Longest buffer suffix that is a proper prefix of a marker."""
        best = 0
        for m in self.parser.STREAM_MARKERS:
            for k in range(min(len(m) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(m[:k]):
                    best = max(best, k)
                    break
        return best

    def _emit_new(self, calls: List[ToolCall]) -> List[dict]:
        """OpenAI streamed tool_call delta pair per NEW call (indices
        continue from what was already emitted)."""
        deltas = []
        for call in calls:
            i, c = self.n_emitted, call.to_openai()
            deltas.append({"index": i, "id": c["id"], "type": "function",
                           "function": {"name": c["function"]["name"],
                                        "arguments": ""}})
            deltas.append({"index": i, "function": {
                "arguments": c["function"]["arguments"]}})
            self.n_emitted += 1
        return deltas

    def feed(self, delta: str) -> Tuple[str, List[dict]]:
        """Returns (text_delta_to_emit, tool_call_deltas)."""
        self.buf += delta
        if not self.parser.STREAM_MARKERS:
            out, self.buf = self.buf, ""
            return out, []
        text = ""
        if not self.in_tool:
            hits = [i for i in (self.buf.find(m)
                                for m in self.parser.STREAM_MARKERS)
                    if i >= 0]
            if hits:
                cut = min(hits)
                text, self.buf = self.buf[:cut], self.buf[cut:]
                self.in_tool = True
            else:
                keep = self._held_suffix_len()
                cut = len(self.buf) - keep
                text, self.buf = self.buf[:cut], self.buf[cut:]
        deltas = []
        if self.in_tool and self._new_unit_ended():
            # only the unconsumed tail is re-parsed, and only when a NEW
            # end marker arrived — O(unit) per completed call, not per token
            calls, end = self.parser.completed_calls(self.buf[self._done:],
                                                     self.schemas)
            deltas = self._emit_new(calls)
            self._done += end
        return text, deltas

    def _new_unit_ended(self) -> bool:
        ends = self.parser.END_MARKERS
        if not ends:
            return True     # no marker info → parse every feed
        overlap = max(len(m) for m in ends) - 1
        start = max(self._done, self._scanned - overlap)
        window = self.buf[start:]
        self._scanned = len(self.buf)
        return any(m in window for m in ends)

    def finish(self) -> Tuple[str, List[dict]]:
        """Flush: full parse of the held buffer. Content surviving the
        parse (trailing / interleaved assistant text, malformed markup) is
        returned as a final text delta; not-yet-emitted calls as deltas."""
        content, calls = self.parser.parse(self.buf, self.schemas)
        if self.in_tool:
            # A stream can end mid-section (e.g. length-capped before the
            # section-end marker): recover the complete per-unit calls and
            # drop the raw markup remnant instead of leaking it as content.
            unit_calls, _ = self.parser.completed_calls(self.buf,
                                                        self.schemas)
            if len(unit_calls) > len(calls):
                calls = unit_calls
                content = ""
        self.buf = ""
        return content, self._emit_new(calls[self.n_emitted:])

    @property
    def saw_tool_calls(self) -> bool:
        return self.n_emitted > 0


_PARSERS = {
    "qwen": QwenToolParser,
    "hermes": QwenToolParser,
    "qwen3.5": Qwen3XmlToolParser,
    "qwen3_5": Qwen3XmlToolParser,
    "qwen_xml": Qwen3XmlToolParser,
    "deepseek": DeepSeekToolParser,
    "kimi": KimiToolParser,
    "none": ToolParser,
}


def _is_qwen35(s: str) -> bool:
    return "qwen3.5" in s or "qwen3_5" in s or "qwen3-5" in s


def get_tool_parser(name: Optional[str] = None,
                    model_name: str = "",
                    architecture: str = "") -> ToolParser:
    """Explicit name, or auto-detect from the model id / architecture
    (reference api_server.py:543-575 + tool_parsers.py:616-623: Qwen3.5
    switched from Hermes JSON to the ``<function=..>`` XML form, so the
    qwen-family resolves on the architecture string)."""
    if name:
        if name not in _PARSERS:
            raise ValueError(f"unknown tool parser {name!r}; "
                             f"choices: {sorted(_PARSERS)}")
        if name == "qwen" and _is_qwen35(architecture.lower()):
            return Qwen3XmlToolParser()
        return _PARSERS[name]()
    m = model_name.lower()
    arch = architecture.lower()
    if _is_qwen35(m) or _is_qwen35(arch):
        return Qwen3XmlToolParser()
    if "qwen" in m or "qwen" in arch:
        return QwenToolParser()
    if "deepseek" in m or "deepseek" in arch:
        return DeepSeekToolParser()
    if "kimi" in m or "kimi" in arch:
        return KimiToolParser()
    return ToolParser()


def schemas_from_tools(tools: Optional[List[dict]]) -> Dict[str, dict]:
    """OpenAI `tools` request field → {name: parameters-schema}."""
    out: Dict[str, dict] = {}
    for t in tools or []:
        fn = t.get("function", {})
        if fn.get("name"):
            out[fn["name"]] = fn.get("parameters", {})
    return out
