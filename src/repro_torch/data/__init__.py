"""Synthetic prompt generation."""
