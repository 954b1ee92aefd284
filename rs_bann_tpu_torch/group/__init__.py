"""Marker groupings (which SNPs feed which branch)."""
