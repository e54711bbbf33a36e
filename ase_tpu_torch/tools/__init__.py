"""Offline tools: importers, retargeting, playback rendering."""
