"""The open-loop load generator of the `http` driver, run in a child process
so that its threads do not share the server's interpreter lock. It imports
the standard library alone.

`run` waits for "go", then sends each request of the schedule when it is
due, each from a thread and a connection of its own, so that it never
waits for an earlier answer; it reads every answer to its last byte. A
request's latency runs from the moment it was due to its last byte.
Answers that are only counted are read into one scratch buffer, so that
the generator does not allocate and fault in each 14-42 MB answer on the
cores the server shares; the kept ones are read whole.
"""

from __future__ import annotations

import http.client
import threading
import time

TIMEOUT_S = 120.0
SCRATCH_BYTES = 1 << 20


def run(conn, port: int, schedule: list[tuple[float, int]], bodies: list[bytes],
        keep: set[int]) -> None:
    """schedule: (due seconds from "go", body index) in time order. Sends
    back (results, kept, last_byte): results[j] = (due, late_s, latency_s,
    status, bytes); kept[j] = (X-Stem-Order, body) for the requests in
    `keep` answered with 200; last_byte, the `time.perf_counter()` at which
    the last answer ended (the clock is the system's monotonic one, which
    the parent shares), or at "go" where nothing was sent."""
    conn.send("ready")
    conn.recv()
    results: list = [None] * len(schedule)
    kept: dict = {}
    start = time.perf_counter()
    ends = [start]
    scratch = bytearray(SCRATCH_BYTES)  # overwritten by every thread, never read

    def send(j: int, due: float, body: int) -> None:
        due_at = start + due
        late = time.perf_counter() - due_at
        status, data, order, size = -1, b"", None, 0
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
            try:
                c.request("POST", "/separate?format=wav8ch", body=bodies[body],
                          headers={"Content-Type": "audio/wav"})
                r = c.getresponse()
                if j in keep:
                    data = r.read()
                    size = len(data)
                else:
                    while n := r.readinto(scratch):
                        size += n
                status, order = r.status, r.getheader("X-Stem-Order")
            finally:
                c.close()
        except (OSError, http.client.HTTPException):
            pass
        end = time.perf_counter()
        results[j] = (due, late, end - due_at, status, size)
        ends.append(end)
        if j in keep and status == 200:
            kept[j] = (order, data)

    threads = []
    for j, (due, body) in enumerate(schedule):
        wait = start + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=send, args=(j, due, body))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    conn.send((results, kept, max(ends)))
    conn.close()
