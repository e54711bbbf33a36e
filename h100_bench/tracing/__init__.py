"""Trace reading and the spans the harness wraps around the program's layers."""
