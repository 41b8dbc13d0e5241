"""Drivers of a cell's window, one a kind of traffic, named by a mix's
``driver`` key."""
