"""Analytic cost priors for the H100 (``roofline``)."""
