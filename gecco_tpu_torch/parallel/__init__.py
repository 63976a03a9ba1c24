"""Multi-host helpers of the port (host code only so far)."""
