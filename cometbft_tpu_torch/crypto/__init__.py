"""Host crypto: keys, the Ed25519 oracle, batch verification."""
