"""The replica axis of a serving replica's device group (`hints`) and the specs of its two modes (`policy`)."""
