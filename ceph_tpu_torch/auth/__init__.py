"""Authentication (reference src/auth/ — CephX, SURVEY §2.6)."""
