"""Artifact store."""
