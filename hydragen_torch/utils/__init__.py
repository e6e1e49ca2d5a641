"""Capacity accounting and timing on the card."""
