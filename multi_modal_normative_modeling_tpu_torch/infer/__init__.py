"""Deviation-score math and the deviation CSV emitters."""
