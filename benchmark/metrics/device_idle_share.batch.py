"""device_idle_share.batch: 1 - device busy time / length of the traced slice."""

from benchmark.lib.trace import idle_share as read  # noqa: F401
