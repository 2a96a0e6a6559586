"""OpenAI-compatible request/response schema (counterpart of
``gllm_tpu/entrypoints/protocol.py``, a copy over this port's
``SamplingParams``).

Chat and completion requests with their sampling knobs, streamed and
whole responses, usage and OpenAI's logprobs shapes (chat's ``content``
list, completions' parallel lists); stdlib dataclasses with explicit
validation. An out-of-range value (``SamplingParams.validate``) becomes a
:class:`ProtocolError` with its message, so the client gets 400.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional, Union

from gllm_tpu_torch.sampling_params import SamplingParams


class ProtocolError(ValueError):
    """Maps to HTTP 400 with an OpenAI-style error body."""


def _get(d: dict, key: str, typ, default=None, required=False):
    if key not in d or d[key] is None:
        if required:
            raise ProtocolError(f"missing required field {key!r}")
        return default
    v = d[key]
    if typ is float and isinstance(v, int):
        v = float(v)
    if not isinstance(v, typ):
        raise ProtocolError(
            f"field {key!r} must be {getattr(typ, '__name__', typ)}")
    return v


def sampling_from_request(d: dict, default_max_tokens: int) -> SamplingParams:
    stop = d.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    elif stop is None:
        stop = []
    elif not (isinstance(stop, list)
              and all(isinstance(s, str) for s in stop)):
        raise ProtocolError("stop must be a string or list of strings")
    logit_bias = d.get("logit_bias")
    if logit_bias is not None:
        if not isinstance(logit_bias, dict):
            raise ProtocolError("logit_bias must be an object")
        try:
            # OpenAI sends token ids as JSON-object string keys
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        except (TypeError, ValueError) as e:
            raise ProtocolError(
                "logit_bias keys must be token ids and values "
                "numbers") from e
    sp = SamplingParams(
        temperature=_get(d, "temperature", float, 1.0),
        top_p=_get(d, "top_p", float, 1.0),
        top_k=_get(d, "top_k", int, -1),
        min_p=_get(d, "min_p", float, 0.0),
        logit_bias=logit_bias,
        repetition_penalty=_get(d, "repetition_penalty", float, 1.0),
        presence_penalty=_get(d, "presence_penalty", float, 0.0),
        frequency_penalty=_get(d, "frequency_penalty", float, 0.0),
        max_tokens=_get(d, "max_tokens", int,
                        _get(d, "max_completion_tokens", int,
                             default_max_tokens)),
        ignore_eos=_get(d, "ignore_eos", bool, False),
        stop_token_ids=_get(d, "stop_token_ids", list, []),
        stop=stop,
        prompt_logprobs=_get(d, "prompt_logprobs", int, None),
        seed=_get(d, "seed", int, None),
    )
    logprobs = d.get("logprobs")
    if isinstance(logprobs, bool):
        sp.logprobs = _get(d, "top_logprobs", int, 0) if logprobs else None
    elif isinstance(logprobs, int):
        sp.logprobs = logprobs
    try:
        sp.validate()
    except ValueError as e:
        raise ProtocolError(str(e)) from e
    return sp


def n_best_of(d: dict):
    n = _get(d, "n", int, 1)
    best_of = _get(d, "best_of", int, n)
    if n < 1 or best_of < n:
        raise ProtocolError("need n >= 1 and best_of >= n")
    return n, best_of


@dataclasses.dataclass
class ChatCompletionRequest:
    messages: List[Dict[str, Any]]
    model: str
    sampling: SamplingParams
    stream: bool
    chat_template_kwargs: Dict[str, Any]
    tools: List[Dict[str, Any]]
    tool_choice: Any
    n: int = 1
    best_of: int = 1

    @classmethod
    def from_dict(cls, d: dict, default_max_tokens: int):
        messages = _get(d, "messages", list, required=True)
        if not messages:
            raise ProtocolError("messages must be non-empty")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m:
                raise ProtocolError("each message needs a 'role'")
        n, best_of = n_best_of(d)
        return cls(
            messages=messages,
            model=_get(d, "model", str, ""),
            sampling=sampling_from_request(d, default_max_tokens),
            stream=_get(d, "stream", bool, False),
            chat_template_kwargs=_get(d, "chat_template_kwargs", dict, {}),
            tools=_get(d, "tools", list, []),
            tool_choice=d.get("tool_choice", "auto"),
            n=n, best_of=best_of,
        )


@dataclasses.dataclass
class CompletionRequest:
    prompt: Union[str, List[int]]
    model: str
    sampling: SamplingParams
    stream: bool
    echo: bool
    n: int = 1
    best_of: int = 1

    @classmethod
    def from_dict(cls, d: dict, default_max_tokens: int):
        prompt = d.get("prompt")
        if isinstance(prompt, list):
            if not all(isinstance(t, int) for t in prompt):
                raise ProtocolError("token-array prompt must be ints")
        elif not isinstance(prompt, str):
            raise ProtocolError("prompt must be a string or token array")
        n, best_of = n_best_of(d)
        return cls(
            prompt=prompt,
            model=_get(d, "model", str, ""),
            sampling=sampling_from_request(d, default_max_tokens),
            stream=_get(d, "stream", bool, False),
            echo=_get(d, "echo", bool, False),
            n=n, best_of=best_of,
        )


# ---- responses ---------------------------------------------------------------

def _id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chat_logprobs_content(lp_entries, decode) -> Optional[dict]:
    """OpenAI's chat logprobs: {"content": [{token, logprob, bytes,
    top_logprobs: [...]}, ...]} from (token id, (chosen, top ids, top
    logprobs)) pairs."""
    if lp_entries is None:
        return None
    content = []
    for tok_id, (chosen, top_ids, top_lps) in lp_entries:
        tok = decode(tok_id)
        content.append({
            "token": tok,
            "logprob": chosen,
            "bytes": list(tok.encode()),
            "top_logprobs": [
                {"token": decode(i), "logprob": lp,
                 "bytes": list(decode(i).encode())}
                for i, lp in zip(top_ids, top_lps)],
        })
    return {"content": content}


def completion_logprobs(lp_entries, decode, text_offset0: int = 0) \
        -> Optional[dict]:
    """OpenAI's completions logprobs (tokens, token_logprobs,
    top_logprobs, text_offset) from (token id, entry) pairs; an entry of
    None (the first prompt position under ``echo``) gives None."""
    if lp_entries is None:
        return None
    tokens, token_logprobs, top_logprobs, text_offset = [], [], [], []
    off = text_offset0
    for tok_id, entry in lp_entries:
        tok = decode(tok_id)
        tokens.append(tok)
        text_offset.append(off)
        off += len(tok)
        if entry is None:
            token_logprobs.append(None)
            top_logprobs.append(None)
            continue
        chosen, top_ids, top_lps = entry
        token_logprobs.append(chosen)
        top_logprobs.append({decode(i): lp
                             for i, lp in zip(top_ids, top_lps)})
    return {"tokens": tokens, "token_logprobs": token_logprobs,
            "top_logprobs": top_logprobs, "text_offset": text_offset}


def chat_completion_response(model: str, choices: list,
                             usage: dict) -> dict:
    """choices: [{"text", "finish_reason", "tool_calls"?, "logprobs"?}]"""
    out = []
    for i, c in enumerate(choices):
        message: Dict[str, Any] = {"role": "assistant",
                                   "content": c["text"]}
        finish = c["finish_reason"]
        if c.get("tool_calls"):
            message["tool_calls"] = c["tool_calls"]
            message["content"] = c["text"] or None
            finish = "tool_calls"
        out.append({"index": i, "message": message,
                    "finish_reason": finish,
                    "logprobs": c.get("logprobs")})
    return {
        "id": _id("chatcmpl"),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": out,
        "usage": usage,
    }


def chat_completion_chunk(rid: str, model: str, delta: Optional[str],
                          finish_reason: Optional[str],
                          role: bool = False, index: int = 0) -> dict:
    d: Dict[str, Any] = {}
    if role:
        d["role"] = "assistant"
    if delta:
        d["content"] = delta
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": index, "delta": d,
                     "finish_reason": finish_reason}],
    }


def completion_response(model: str, choices: list, usage: dict) -> dict:
    """choices: [{"text", "finish_reason", "logprobs"?}]"""
    return {
        "id": _id("cmpl"),
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": i, "text": c["text"],
                     "finish_reason": c["finish_reason"],
                     "logprobs": c.get("logprobs")}
                    for i, c in enumerate(choices)],
        "usage": usage,
    }


def completion_chunk(rid: str, model: str, delta: str,
                     finish_reason: Optional[str],
                     index: int = 0) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": index, "text": delta,
                     "finish_reason": finish_reason, "logprobs": None}],
    }


def error_response(message: str, code: int = 400) -> dict:
    return {"error": {"message": message, "type": "invalid_request_error",
                      "code": code}}


def stream_error_event(message, finish_reason: str = "error",
                       retry_after=None) -> dict:
    """Terminal SSE error event: emitted after the finish chunk when a
    stream ends with a server-side failure, carrying the failure detail
    and — for transient failures — the ``retry_after`` backoff hint
    (the StreamChunk.retry_after the plain-chunk rendering used to
    drop). Routers and backoff-aware clients key on it; ordinary
    clients that stop at the finish_reason chunk are unaffected."""
    err = {"message": message or finish_reason, "type": "server_error",
           "code": finish_reason}
    if retry_after is not None:
        err["retry_after"] = round(float(retry_after), 3)
    return {"error": err}


def new_request_id(chat: bool) -> str:
    return _id("chatcmpl" if chat else "cmpl")
