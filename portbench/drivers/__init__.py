"""Drivers, one per kind of cell (a traffic file names its driver)."""
