"""The component topology of the scatter-gather tier."""
