"""Scenario generators (numpy; equal arrays to the reference at equal seeds)."""
