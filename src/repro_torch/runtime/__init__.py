"""Runtime support (`fault_tolerance`): the restart driver, heartbeat and straggler monitors."""
