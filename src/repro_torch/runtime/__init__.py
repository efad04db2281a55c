"""Runtime support for serving: heartbeat and straggler monitors (`fault_tolerance`)."""
