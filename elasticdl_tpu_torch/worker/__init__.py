"""Worker-side contracts of the port (only the prediction sink so
far)."""
