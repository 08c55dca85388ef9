"""Supervised task execution with a shared shutdown signal.

Python rendering of lighthouse/common/task_executor/src/lib.rs:281
(spawn / spawn_blocking with panic monitoring, the exit future every task
watches, and the shutdown-sender any task can use to bring the whole client
down) — threads instead of tokio tasks.

Semantics preserved:
  - every spawned task is named and monitored: an uncaught exception is
    recorded (metrics + log) and, for `critical` tasks, triggers a client
    shutdown with the failure as the reason (the reference's
    panic-monitor -> shutdown path);
  - `shutdown(reason)` fires the exit event; tasks poll `exit` (or wait on
    it) to terminate; `wait_shutdown` gives the main thread the reason;
  - shutdown is idempotent — the FIRST reason wins (Sender<ShutdownReason>).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class TaskHandle:
    name: str
    thread: threading.Thread
    error: BaseException | None = None

    def join(self, timeout: float | None = None) -> None:
        self.thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self.thread.is_alive()


@dataclass
class TaskExecutor:
    name: str = "client"
    exit: threading.Event = field(default_factory=threading.Event)
    tasks: list[TaskHandle] = field(default_factory=list)
    _shutdown_reason: str | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def spawn(self, fn, name: str, *args, critical: bool = False, **kwargs) -> TaskHandle:
        """Run `fn(*args, **kwargs)` on a supervised daemon thread. A
        `critical` task's uncaught exception shuts the client down
        (spawn_monitor's panic path); non-critical failures are logged and
        counted but the client keeps running."""
        handle = TaskHandle(name=name, thread=None)  # type: ignore[arg-type]

        def run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — supervision boundary
                handle.error = e
                from .logging import KvLogger
                from .metrics import TASKS_FAILED_TOTAL

                TASKS_FAILED_TOTAL.inc()
                KvLogger("task_executor").error(
                    "task died", task=name, error=repr(e), critical=critical
                )
                if critical:
                    self.shutdown(f"critical task '{name}' failed: {e!r}")

        handle.thread = threading.Thread(target=run, name=f"{self.name}/{name}", daemon=True)
        with self._lock:
            self.tasks.append(handle)
        handle.thread.start()
        return handle

    def shutdown(self, reason: str) -> None:
        """Request client shutdown; the first reason wins."""
        with self._lock:
            if self._shutdown_reason is None:
                self._shutdown_reason = reason
        self.exit.set()

    @property
    def shutdown_reason(self) -> str | None:
        return self._shutdown_reason

    def wait_shutdown(self, timeout: float | None = None) -> str | None:
        """Block until shutdown is requested; returns the reason."""
        self.exit.wait(timeout)
        return self._shutdown_reason

    def join_all(self, timeout: float = 5.0) -> list[TaskHandle]:
        """Join every task (bounded); returns handles still alive after."""
        with self._lock:
            tasks = list(self.tasks)
        for t in tasks:
            t.join(timeout)
        return [t for t in tasks if t.alive]
