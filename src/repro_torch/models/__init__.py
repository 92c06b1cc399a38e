"""Model families ported so far: dense decoder-only."""
