"""OpenAI-compatible chat endpoint bridging HTTP into a dataflow
(dora_tpu/nodehub/openai_server.py).

``POST /v1/chat/completions`` publishes the last user message on the
``text`` output and answers with what arrives on the ``response`` input;
``GET /v1/models`` lists one model. Stdlib ``http.server``, one thread a
request; the node's event loop hands responses to the request threads
through queues.

Serial mode (the default): one request at a time, its answer the next
``response``. ``"stream": true`` answers as Server-Sent Events
(``chat.completion.chunk`` deltas, then ``[DONE]``): a dataflow that answers
in several messages streams each as one delta, and the stream closes after
``STREAM_QUIET_MS`` (default 300) of silence after the first.

Concurrent mode (``DORA_OPENAI_CONCURRENT=1``): requests are not serialized.
Each prompt goes out with metadata ``request_id`` (and ``max_new_tokens``,
``model``, ``qos_class``, ``deadline_ms`` when the request names them), and
the responder answers with ``request_id`` echoed and ``done`` on the last
chunk (``finish``: "stop", "length", "overloaded" or "rejected"); the
serving node (``nodehub/llm_server.py``) speaks this. A shed request answers
429 with ``Retry-After``, a rejected one 400.

``RESPONSE_TIMEOUT`` (default 30 s) bounds the wait for a response (a stream
that stalls ends as "length"); ``MAX_REQUESTS`` (default 0: forever) ends
the node after that many requests; ``PORT`` (default 8123).

Dataflow usage::

    - id: api
      path: module:dora_tpu_torch.nodehub.openai_server
      outputs: [text]
      inputs: {response: llm/response}
      env: {PORT: "8123", DORA_OPENAI_CONCURRENT: "1"}
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pyarrow as pa

from dora_tpu_torch.node import Node


def main() -> None:
    import uuid

    port = int(os.environ.get("PORT", "8123"))
    timeout_s = float(os.environ.get("RESPONSE_TIMEOUT", "30"))
    max_requests = int(os.environ.get("MAX_REQUESTS", "0"))  # 0 = serve forever
    quiet_s = float(os.environ.get("STREAM_QUIET_MS", "300")) / 1000.0
    concurrent = os.environ.get("DORA_OPENAI_CONCURRENT", "0") not in (
        "", "0"
    )
    node = Node()
    responses: queue.Queue = queue.Queue()
    #: concurrent mode: request_id -> its private chunk queue
    routed: dict[str, queue.Queue] = {}
    routed_lock = threading.Lock()
    # Serial mode holds this across send_output + the reply queue
    # get: whole-request serialization is the documented contract
    # (node.send_output is not thread-safe).
    send_lock = threading.Lock()
    served = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(
                    {"object": "list",
                     "data": [{"id": "dora-tpu", "object": "model"}]}
                )
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", "0"))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                messages = body.get("messages", [])
                text = next(
                    (m.get("content", "") for m in reversed(messages)
                     if m.get("role") == "user"),
                    "",
                )
            except (ValueError, AttributeError) as e:
                self.send_error(400, str(e))
                return
            stream = bool(body.get("stream"))
            model = body.get("model", "dora-tpu")
            if concurrent:
                self._serve_concurrent(body, text, stream, model)
                return
            with send_lock:
                # Drain stale responses, publish, await the next one.
                while not responses.empty():
                    responses.get_nowait()
                node.send_output("text", pa.array([text]))
                try:
                    answer = responses.get(timeout=timeout_s)
                except queue.Empty:
                    self.send_error(504, "dataflow did not answer in time")
                    return
                # From here the request counts as served no matter how the
                # write ends (a client disconnect mid-stream must not keep
                # a MAX_REQUESTS-bounded server alive forever) — but count
                # only after the write so shutdown cannot race an
                # in-flight response (the main loop polls `served`).
                try:
                    if stream:
                        # Forward follow-up chunks until the dataflow goes
                        # quiet (multi-message answers stream as deltas).
                        self._sse_start()
                        self._sse_chunk(model, {"role": "assistant"})
                        self._sse_chunk(model, {"content": answer})
                        while True:
                            try:
                                more = responses.get(timeout=quiet_s)
                            except queue.Empty:
                                break
                            self._sse_chunk(model, {"content": more})
                        self._sse_chunk(model, {}, finish="stop")
                        self.wfile.write(b"data: [DONE]\n\n")
                    else:
                        self._json(
                            {
                                "id": "chatcmpl-dora-tpu",
                                "object": "chat.completion",
                                "created": int(time.time()),
                                "model": model,
                                "choices": [
                                    {
                                        "index": 0,
                                        "message": {
                                            "role": "assistant",
                                            "content": answer,
                                        },
                                        "finish_reason": "stop",
                                    }
                                ],
                            }
                        )
                finally:
                    served[0] += 1

        def _serve_concurrent(self, body, text, stream, model):
            """Routed request: publish tagged with a request_id, stream
            chunks back as they arrive — other requests interleave
            freely (the responder batches them; nothing serializes)."""
            rid = uuid.uuid4().hex[:12]
            chunks: queue.Queue = queue.Queue()
            with routed_lock:
                routed[rid] = chunks
            try:
                meta = {"request_id": rid}
                if isinstance(body.get("max_tokens"), int):
                    meta["max_new_tokens"] = body["max_tokens"]
                # Multi-tenant LoRA routing: the requested model name
                # travels with the request; the serving node resolves a
                # non-base name against its adapter catalog and rejects
                # unknown tenants with a structured finish (so the 404
                # semantics live where the catalog lives, not here).
                if isinstance(model, str) and model:
                    meta["model"] = model
                # Traffic shaping: the body wins over the header so a
                # proxy-injected default never overrides an explicit
                # request. Unknown class strings pass through — the
                # responder folds them to its configured default.
                qos = (
                    body.get("qos_class")
                    or body.get("priority")
                    or self.headers.get("x-dora-qos")
                )
                if isinstance(qos, str) and qos:
                    meta["qos_class"] = qos
                deadline = body.get("deadline_ms")
                if deadline is None:
                    try:
                        deadline = float(
                            self.headers.get("x-dora-deadline-ms", "")
                        )
                    except ValueError:
                        deadline = None
                if isinstance(deadline, (int, float)) and deadline > 0:
                    meta["deadline_ms"] = float(deadline)
                with send_lock:  # send_output is not thread-safe
                    node.send_output("text", pa.array([text]), meta)
                if stream:
                    self._sse_start()
                    self._sse_chunk(model, {"role": "assistant"})
                parts: list[str] = []
                finished = False
                finish_reason = None  # responder's tag: "stop" | "length"
                extra: dict = {}  # shed/reject detail (retry_after_ms, ...)
                while True:
                    try:
                        delta, done, finish, extra = chunks.get(
                            timeout=timeout_s
                        )
                    except queue.Empty:
                        if not stream:
                            # Stalled mid-answer: a truncated completion
                            # marked "stop" would silently lie — fail
                            # like the serial path does.
                            self.send_error(
                                504, "dataflow did not answer in time"
                            )
                            return
                        break
                    if delta:
                        if stream:
                            self._sse_chunk(model, {"content": delta})
                        else:
                            parts.append(delta)
                    if done:
                        finished = True
                        finish_reason = finish
                        break
                if stream:
                    # Prefer the responder's own tag (done-by-EOS =
                    # "stop", done-by-cap = "length"); a stream that
                    # timed out before the done marker is truncated:
                    # say so ("length"), don't claim a clean stop.
                    self._sse_chunk(
                        model,
                        {},
                        finish=(finish_reason or "stop")
                        if finished
                        else "length",
                        extra=extra or None,
                    )
                    self.wfile.write(b"data: [DONE]\n\n")
                elif finished and not parts and finish_reason in (
                    "overloaded", "rejected"
                ):
                    # Shed (retriable, 429 + Retry-After) or structurally
                    # impossible (400) — a 200 with empty content would
                    # hide the backpressure from every standard client.
                    retry_ms = extra.get("retry_after_ms")
                    headers = (
                        {"Retry-After": str(max(1, int(retry_ms / 1000.0)))}
                        if retry_ms
                        else None
                    )
                    self._json(
                        {
                            "error": {
                                "message": f"request {finish_reason}",
                                "type": finish_reason,
                                **({"dora": extra} if extra else {}),
                            }
                        },
                        status=429 if finish_reason == "overloaded" else 400,
                        headers=headers,
                    )
                else:
                    self._json(
                        {
                            "id": f"chatcmpl-{rid}",
                            "object": "chat.completion",
                            "created": int(time.time()),
                            "model": model,
                            "choices": [
                                {
                                    "index": 0,
                                    "message": {
                                        "role": "assistant",
                                        "content": "".join(parts),
                                    },
                                    "finish_reason": finish_reason or "stop",
                                }
                            ],
                        }
                    )
            finally:
                with routed_lock:
                    routed.pop(rid, None)
                served[0] += 1

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

        def _sse_chunk(self, model: str, delta: dict, finish=None,
                       extra: dict | None = None):
            payload = {
                "id": "chatcmpl-dora-tpu",
                "object": "chat.completion.chunk",
                "created": int(time.time()),
                "model": model,
                "choices": [
                    {"index": 0, "delta": delta, "finish_reason": finish}
                ],
            }
            if extra:
                # Shed/reject detail (retry_after_ms, pages_needed, ...)
                # rides in a vendor key — OpenAI clients ignore it.
                payload["dora"] = extra
            self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
            self.wfile.flush()

        def _json(self, payload: dict, status: int = 200,
                  headers: dict | None = None):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for key, val in (headers or {}).items():
                self.send_header(key, val)
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"openai server listening on 127.0.0.1:{server.server_address[1]}")

    try:
        while True:
            if max_requests and served[0] >= max_requests:
                break
            event = node.recv(timeout=0.25)
            if event is None:
                if node.stream_ended:
                    break
                continue
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            value = event["value"]
            if isinstance(value, pa.Array):
                items = value.to_pylist()
                if items and isinstance(items[0], str):
                    answer = " ".join(str(i) for i in items)
                else:
                    from dora_tpu_torch.models import tokenizer

                    answer = tokenizer.decode(items)
            else:
                answer = bytes(value or b"").decode(errors="replace")
            meta = event.get("metadata") or {}
            rid = meta.get("request_id")
            if rid is not None:
                with routed_lock:
                    target = routed.get(rid)
                if target is not None:  # client gone: drop silently
                    extra = {
                        k: meta[k]
                        for k in ("retry_after_ms", "reject_reason",
                                  "pages_needed", "pool_pages", "max_seq")
                        if meta.get(k) is not None
                    }
                    target.put(
                        (answer, bool(meta.get("done")),
                         meta.get("finish"), extra)
                    )
                continue
            responses.put(answer)
    finally:
        server.shutdown()
        node.close()


if __name__ == "__main__":
    main()
