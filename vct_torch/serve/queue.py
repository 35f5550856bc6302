"""PUSH/PULL work queue over plain TCP sockets: the port's copy of
``vct/serve/queue.py``.

The reference wires backend -> worker with ZeroMQ PUSH/PULL
(``backend.py:20-33`` PUSH connect, ``worker.py:135-147`` PULL bind).
pyzmq is not a dependency here; this is the same topology on stdlib sockets:
the puller *binds* the port and accepts many pushers; messages are
newline-delimited JSON. Pushers reconnect per send (messages are tiny URLs —
connection cost is irrelevant next to a video download + inference)."""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable, Iterator, Optional

__all__ = ["QueuePush", "QueuePull"]


class QueuePush:
    """Connect-and-send side (the backend, backend.py:24-33)."""

    def __init__(self, host: str = "localhost", port: int = 54000, timeout: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    def send(self, message: dict | str) -> None:
        payload = message if isinstance(message, str) else json.dumps(message)
        with socket.create_connection((self.host, self.port), self.timeout) as s:
            s.sendall(payload.encode() + b"\n")


class QueuePull:
    """Bind-and-receive side (the worker, worker.py:135-147)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 54000):
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()

    def bind(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(16)
        self._sock.settimeout(0.5)

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def messages(self) -> Iterator[str]:
        """Yield decoded message strings until close()."""
        if self._sock is None:
            self.bind()
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                buf = b""
                conn.settimeout(5.0)
                try:
                    while True:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        buf += chunk
                except socket.timeout:
                    pass
                for line in buf.split(b"\n"):
                    if line.strip():
                        yield line.decode()

    def consume(self, callback: Callable[[str], None]) -> None:
        """worker.py:144-151 loop: process each message, swallow per-message
        errors, keep consuming."""
        for message in self.messages():
            try:
                callback(message)
            except Exception as e:
                print(f"Error processing message {message!r}: {e}")
