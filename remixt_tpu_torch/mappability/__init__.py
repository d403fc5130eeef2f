"""Mappability store construction (k-mer realignment pipeline)."""
