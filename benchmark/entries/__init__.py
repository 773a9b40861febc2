"""The program entries each traffic mix drives."""
