"""Model configurations the port serves (paper eval models)."""
