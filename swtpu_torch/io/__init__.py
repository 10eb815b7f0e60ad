"""FASTA ingestion."""
