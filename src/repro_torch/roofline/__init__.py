"""Roofline terms: the analytic cost model and the H100's constants."""
