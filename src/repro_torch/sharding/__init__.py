"""Layouts of the LM's parameters, batches and caches on a device mesh."""
