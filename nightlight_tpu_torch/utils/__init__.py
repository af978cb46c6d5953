"""Shared utilities: log plumbing."""
