"""Ingestion and persistence: FASTA, shard manifests."""
