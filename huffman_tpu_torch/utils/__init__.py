"""Helpers of the port that no codec path calls (``debug``)."""
