"""Utilities of the port: the torch reference's checkpoint importer."""
