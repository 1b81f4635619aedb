"""Trace transforms of the port: autodiff and autocast."""
