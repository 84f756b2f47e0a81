"""Data layer: CSV ingestion, preprocessing, synthetic cohorts."""
