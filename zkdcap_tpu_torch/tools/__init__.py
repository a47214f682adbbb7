"""Measurement tools of the port that run only on a card."""
