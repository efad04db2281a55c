"""Runtime support: heartbeat and straggler monitors (`fault_tolerance`) for serving and training."""
