"""Roofline terms for the H100."""
