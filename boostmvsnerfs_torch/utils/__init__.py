"""Weight conversion and synthetic scenes."""
