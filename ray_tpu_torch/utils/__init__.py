"""Test helpers of the port (the fail points)."""
