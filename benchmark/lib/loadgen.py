"""An open-loop HTTP load generator, run in a process of its own so that
it shares no interpreter lock with the server it measures. Standard
library only.

Each request is sent at its due time, on a thread of its own, whether
or not earlier ones have been answered; a reply is timed from the due
time. After the last due time the generator waits up to `drain_s` for
outstanding replies; one that has not come by then is missing.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request


def _post(url: str, body: bytes, timeout: float):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def run(url: str, bodies, offsets, t0: float, drain_s: float, keep, out_q) -> None:
    """Send `bodies[i]` at monotonic time t0 + offsets[i]; put one list of
    records on `out_q`: (i, due, sent, done or None, status, reply fields
    or None, kept payload or None). `keep` holds the indices whose whole
    reply (PNG fields) comes back."""
    n = len(bodies)
    rec = [None] * n
    deadline = t0 + (max(offsets) if n else 0.0) + drain_s

    def one(i, due):
        sent = time.monotonic()
        status, fields, payload, done = 0, None, None, None
        try:
            status, raw = _post(url, bodies[i], max(deadline - sent, 1.0))
            done = time.monotonic()
            data = json.loads(raw)
            if status == 200 and "error" not in data:
                fields = {"relevancy_max": data.get("relevancy_max"),
                          "selected_px": data.get("selected_px")}
                if i in keep:
                    payload = {"heatmap_png": data["heatmap_png"], "mask_png": data["mask_png"]}
            else:
                fields = None
        except (urllib.error.URLError, OSError, ValueError, KeyError) as exc:
            status = f"{type(exc).__name__}: {exc}"
        rec[i] = (i, due, sent, done, status, fields, payload)

    threads = []
    for i in range(n):
        due = t0 + offsets[i]
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=one, args=(i, due), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=max(deadline - time.monotonic(), 0.0) + 5.0)
    out = []
    for i in range(n):
        if rec[i] is None:  # still waiting at the deadline
            out.append((i, t0 + offsets[i], None, None, "no reply by the end of the drain",
                        None, None))
        else:
            out.append(rec[i])
    out_q.put(out)


def main(job_q, ready_q, out_q) -> None:
    """Process entry: announce readiness, take one job, run it."""
    ready_q.put("ready")
    run(**job_q.get(), out_q=out_q)
