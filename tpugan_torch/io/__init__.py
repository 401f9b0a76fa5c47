"""Weight bridge and image files."""
