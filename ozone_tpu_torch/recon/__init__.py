"""Recon: the cluster observability warehouse and its REST API and UI."""
